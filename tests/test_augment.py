"""--addsky / --envname made real (the reference stubs both with a
warning, src/jtrace.jl:35-46): the procedural Perez/Preetham sun-sky
must be physically sensible, and both augmentations must render through
the full pipeline with env importance sampling."""

import jax.numpy as jnp
import numpy as np

from julia_raytracer.scene.augment import add_environment, add_sky, make_sunsky
from julia_raytracer.scene.generate import ensure_scene


def test_sunsky_physical_shape():
    img = make_sunsky(width=256, height=128, sun_elevation=np.pi / 4)
    assert img.shape == (128, 256, 4)
    assert np.isfinite(img).all() and (img >= 0).all()
    rgb = img[..., :3]
    # sun at phi=0, elevation 45deg -> zenith angle 45deg -> v=0.25
    sun_px = rgb[32, 0]
    assert sun_px.max() == rgb.reshape(-1, 3).max()  # sun disk brightest
    # zenith bluer than it is red; horizon brighter than zenith (Perez
    # exp(B/cos) horizon brightening at low turbidity)
    zenith = rgb[1].mean(axis=0)
    horizon = rgb[62].mean(axis=0)
    assert zenith[2] > zenith[0]
    assert horizon.mean() > zenith.mean()
    # ground darker than sky
    assert rgb[96:].mean() < rgb[:64].mean()


def test_sunsky_elevation_moves_sun():
    lo = make_sunsky(width=128, height=64, sun_elevation=np.deg2rad(10))
    hi = make_sunsky(width=128, height=64, sun_elevation=np.deg2rad(70))
    row_lo = np.unravel_index(np.argmax(lo[..., 1]), lo.shape[:2])[0]
    row_hi = np.unravel_index(np.argmax(hi[..., 1]), hi.shape[:2])[0]
    assert row_hi < row_lo  # higher sun -> closer to zenith row 0


def test_addsky_renders():
    from julia_raytracer.render.integrator import (
        TraceOptions, make_intersect, trace_wavefront,
    )
    from julia_raytracer.render.scene_device import build_device_scene
    from julia_raytracer.scene.loader import load_scene
    from julia_raytracer.utils import rng as rng_mod

    scene = load_scene(ensure_scene("cornellbox"))
    n_env0 = len(scene.environments)
    add_sky(scene)
    assert len(scene.environments) == n_env0 + 1
    dsc, cfg = build_device_scene(scene)
    assert cfg.n_envs == n_env0 + 1
    n = 1024
    rng = np.random.default_rng(3)
    ro = np.tile([0.0, 1.0, 3.9], (n, 1)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rngs = rng_mod.seed_state(jnp.arange(n, dtype=jnp.int32), jnp.int32(0), 0)
    opts = TraceOptions(sampler="path", bounces=3)
    rad = trace_wavefront(
        dsc, cfg, opts, jnp.asarray(ro), jnp.asarray(rd), rngs,
        intersect=make_intersect(dsc, cfg),
    )[0]
    rad = np.asarray(rad)
    assert np.isfinite(rad).all() and rad.max() > 0


def test_envname_renders(tmp_path):
    from julia_raytracer.render.scene_device import build_device_scene
    from julia_raytracer.scene.loader import load_scene
    from julia_raytracer.utils.imgio import save_png

    # write a small PNG panorama and add it as an environment
    img = np.zeros((8, 16, 4), np.float32)
    img[..., 0] = 0.8
    img[..., 3] = 1.0
    p = str(tmp_path / "pano.png")
    save_png(p, img, linear=False)
    scene = load_scene(ensure_scene("cornellbox"))
    n_env0 = len(scene.environments)
    n_tex0 = len(scene.textures)
    add_environment(scene, p)
    assert len(scene.environments) == n_env0 + 1
    assert scene.environments[-1].emission_tex == n_tex0
    dsc, cfg = build_device_scene(scene)
    assert cfg.n_envs == n_env0 + 1

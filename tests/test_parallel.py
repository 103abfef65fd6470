"""Multi-device sharding tests on the virtual 8-device CPU mesh:
sharded render == single-device render; sharded train step runs and
produces finite grads (the XLA-inserted psum path)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.parallel.mesh import make_mesh, shard_render_fn, shard_train_step
from julia_raytracer.render.integrator import trace_wavefront
from julia_raytracer.render.renderer import Params, Renderer, make_trace_state
from julia_raytracer.utils import rng as rng_mod
from julia_raytracer.ops.camera import sample_camera


@pytest.fixture(scope="module")
def setup():
    from julia_raytracer.scene.loader import load_scene

    from julia_raytracer.scene.generate import ensure_scene

    scene = load_scene(ensure_scene("cornellbox"))
    params = Params(resolution=32, samples=1, bounces=3, sampler="path")
    r = Renderer(scene, params)
    state = make_trace_state(scene, params)
    return r, state


def _rays(r, state):
    n = state.width * state.height
    pix = jnp.arange(n, dtype=jnp.int32)
    rng = rng_mod.seed_state(pix, jnp.int32(0), 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = jnp.stack([pix % state.width, pix // state.width], axis=-1)
    ro, rd = sample_camera(
        r.cam_arrays, ij, (state.width, state.height), puv, luv, False
    )
    return ro, rd, rng


def test_devices_available():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"


def test_sharded_render_matches_single(setup):
    r, state = setup
    ro, rd, rng = _rays(r, state)
    mesh = make_mesh(8)
    render = shard_render_fn(mesh, r.dscene, r.config, r.options)
    rad_sh, hit_sh, alb_sh, nrm_sh = render(r.dscene, ro, rd, rng)
    rad_1, hit_1, alb_1, nrm_1, _ = trace_wavefront(
        r.dscene, r.config, r.options, ro, rd, rng
    )
    # shard-invariance: the counter-based RNG makes lanes independent of
    # placement; tiny fp drift comes only from GSPMD changing op fusion
    np.testing.assert_allclose(
        np.asarray(rad_sh), np.asarray(rad_1), rtol=5e-4, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(hit_sh), np.asarray(hit_1))


def test_sharded_train_step(setup):
    r, state = setup
    n = state.width * state.height
    mesh = make_mesh(8)
    step = shard_train_step(
        mesh, r.dscene, r.config, r.options, r.cam_arrays, state.width, state.height
    )
    pix = jnp.arange(n, dtype=jnp.int32)
    target = jnp.zeros((n, 3), jnp.float32)
    mats = r.dscene.materials
    loss, new_color, new_emission = step(mats.color, mats.emission, pix, target, 1)
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(new_color)).all()
    assert np.isfinite(np.asarray(new_emission)).all()
    # the light's emission must move (grad flows through the psum)
    assert not np.allclose(np.asarray(new_emission), np.asarray(mats.emission))


def _synthetic_instanced_scene(rng):
    """Small two-shape, five-instance scene with an environment; every
    instance flattens to world space (used by the instanced tests)."""
    from julia_raytracer.scene.types import (
        CameraData, EnvironmentData, InstanceData, MaterialData, SceneData,
        ShapeData,
    )

    def soup(n_tris, scale):
        base = rng.normal(size=(n_tris, 3)).astype(np.float32)
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        e1 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.3
        e2 = rng.normal(size=(n_tris, 3)).astype(np.float32) * 0.3
        pos = np.concatenate(
            [base * scale, base * scale + e1, base * scale + e2]
        )
        tris = np.stack(
            [
                np.arange(n_tris),
                n_tris + np.arange(n_tris),
                2 * n_tris + np.arange(n_tris),
            ],
            axis=1,
        ).astype(np.int32)
        return ShapeData(triangles=tris, positions=pos)

    def frame(deg, t, s=1.0):
        th = np.deg2rad(deg)
        c, sn = np.cos(th), np.sin(th)
        f = np.zeros((4, 3), np.float32)
        f[:3] = np.array([[c, 0, -sn], [0, 1, 0], [sn, 0, c]], np.float32) * s
        f[3] = t
        return f

    return SceneData(
        cameras=[CameraData()],
        shapes=[soup(30, 1.0), soup(20, 0.5)],
        materials=[MaterialData(color=np.array([0.6, 0.7, 0.8], np.float32))],
        instances=[
            InstanceData(frame=frame(30 * i, [1.5 * i - 3, 0, 0]), shape=i % 2,
                         material=0)
            for i in range(5)
        ],
        environments=[
            EnvironmentData(emission=np.array([1.0, 1.0, 1.0], np.float32))
        ],
    )


def _instanced_rays(n, seed):
    srng = np.random.default_rng(seed)
    ro = np.tile([0.0, 0.0, 8.0], (n, 1)).astype(np.float32)
    rd = srng.normal(size=(n, 3)).astype(np.float32)
    rd[:, 2] = -np.abs(rd[:, 2]) - 0.5
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rngs = rng_mod.seed_state(jnp.arange(n, dtype=jnp.int32), jnp.int32(0), 0)
    return jnp.asarray(ro), jnp.asarray(rd), rngs


def test_sharded_instanced_render_matches_single():
    """An instanced scene, flattened to world space, must be GSPMD-clean:
    sharded render over the 8-device mesh == single-device render."""
    from julia_raytracer.render.integrator import TraceOptions
    from julia_raytracer.render.scene_device import build_device_scene

    rng = np.random.default_rng(11)
    dsc, cfg = build_device_scene(_synthetic_instanced_scene(rng))
    assert cfg.n_instances == 5 and cfg.n_prims == 3 * 30 + 2 * 20

    ro, rd, rngs = _instanced_rays(2048, 11)
    opts = TraceOptions(sampler="path", bounces=3)

    mesh = make_mesh(8)
    render = shard_render_fn(mesh, dsc, cfg, opts)
    rad_sh, hit_sh, _, _ = render(dsc, ro, rd, rngs)
    rad_1, hit_1, _, _, _ = trace_wavefront(dsc, cfg, opts, ro, rd, rngs)
    np.testing.assert_allclose(
        np.asarray(rad_sh), np.asarray(rad_1), rtol=5e-4, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(hit_sh), np.asarray(hit_1))


# ---------------------------------------------------------------------------
# multi-device coverage beyond cornellbox — area lights, env importance
# sampling and instancing through the cross-host entry point
# (distributed_render_fn), single-process on the virtual 8-device mesh.
# ---------------------------------------------------------------------------


def _distributed_vs_single(dsc, cfg, opts, ro, rd, rngs):
    from julia_raytracer.parallel.distributed import (
        distributed_render_fn, global_mesh,
    )

    mesh = global_mesh()
    render = distributed_render_fn(mesh, dsc, cfg, opts)
    rad_sh, hit_sh, alb_sh, nrm_sh = render(dsc, ro, rd, rngs)
    rad_1, hit_1, alb_1, nrm_1, _ = trace_wavefront(dsc, cfg, opts, ro, rd, rngs)
    np.testing.assert_allclose(
        np.asarray(rad_sh), np.asarray(rad_1), rtol=5e-4, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(hit_sh), np.asarray(hit_1))
    np.testing.assert_allclose(
        np.asarray(alb_sh), np.asarray(alb_1), rtol=5e-4, atol=1e-6
    )


@pytest.mark.slow
def test_distributed_render_manylights_area_lights_env():
    """manylights (13 emissive materials, occluders) + the procedural
    sun-sky environment (--addsky): exercises segmented area-light CDFs,
    env texel importance sampling, and the MIS pdf sweep under
    distributed_render_fn — sharded == single."""
    from julia_raytracer.scene.augment import add_sky
    from julia_raytracer.scene.generate import ensure_scene
    from julia_raytracer.scene.loader import load_scene

    scene = load_scene(ensure_scene("manylights"))
    add_sky(scene)
    params = Params(resolution=24, samples=1, bounces=3, sampler="path")
    r = Renderer(scene, params)
    state = make_trace_state(scene, params)
    assert r.config.n_envs > 0 and r.config.light_counts.n_instance == 13
    ro, rd, rngs = _rays(r, state)
    _distributed_vs_single(r.dscene, r.config, r.options, ro, rd, rngs)


@pytest.mark.slow
def test_distributed_render_instanced():
    """A flattened instanced scene through distributed_render_fn."""
    from julia_raytracer.render.integrator import TraceOptions
    from julia_raytracer.render.scene_device import build_device_scene

    rng = np.random.default_rng(13)
    dsc, cfg = build_device_scene(_synthetic_instanced_scene(rng))
    ro, rd, rngs = _instanced_rays(2048, 13)
    opts = TraceOptions(sampler="path", bounces=3)
    _distributed_vs_single(dsc, cfg, opts, ro, rd, rngs)

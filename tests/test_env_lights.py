"""Environment-light importance sampling (texel CDFs, src/trace.jl:163-183,
985-1001, 1046-1076): direction validity, pdf normalization, and the
fixed 0-based texel mapping."""

import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.render import lights as L
from julia_raytracer.render.scene_device import build_device_scene


@pytest.fixture(scope="module")
def env_scene():
    from julia_raytracer.scene.loader import load_scene

    from julia_raytracer.scene.generate import ensure_scene

    scene = load_scene(ensure_scene("envmap"))
    return build_device_scene(scene)


def test_env_light_table(env_scene):
    dscene, config = env_scene
    counts = config.light_counts
    assert counts.n_env == 1
    # CDF spans the whole HDR texture
    tex_id = int(dscene.env_emission_tex[0])
    w = int(dscene.textures.width[tex_id])
    h = int(dscene.textures.height[tex_id])
    assert int(dscene.lights.env_cdf_count[0]) == w * h
    cdf = np.asarray(dscene.lights.env_cdf)
    assert (np.diff(cdf[: w * h]) >= 0).all()


def test_env_sample_directions_unit(env_scene):
    dscene, config = env_scene
    counts = config.light_counts
    n = 512
    rng = np.random.default_rng(0)
    pos = jnp.zeros((n, 3), jnp.float32)
    rl = jnp.asarray(
        (counts.n_instance + rng.random(n) * counts.n_env).astype(np.float32)
        / counts.total
    )  # force env picks
    rel = jnp.asarray(rng.random(n, np.float32))
    ruv = jnp.asarray(rng.random((n, 2), np.float32))
    d = np.asarray(
        L.sample_lights(dscene, dscene.lights, counts, pos, rl, rel, ruv)
    )
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)


def test_env_pdf_normalized(env_scene):
    """MC check: integral of the env pdf over the sphere = 1 (per env),
    i.e. mean(pdf(uniform dirs)) * 4pi ~= 1."""
    dscene, config = env_scene
    counts = config.light_counts
    n = 200_000
    rng = np.random.default_rng(1)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pdf = np.asarray(
        L.env_lights_pdf(dscene, dscene.lights, counts, jnp.asarray(d))
    )
    assert np.isfinite(pdf).all() and (pdf >= 0).all()
    integral = pdf.mean() * 4 * np.pi
    np.testing.assert_allclose(integral, 1.0, rtol=0.05)


def test_env_sample_pdf_consistency(env_scene):
    """Sampled texel directions score a much higher pdf than uniform ones
    (the CDF concentrates where the map is bright)."""
    dscene, config = env_scene
    counts = config.light_counts
    n = 4096
    rng = np.random.default_rng(2)
    pos = jnp.zeros((n, 3), jnp.float32)
    rl = jnp.asarray(np.full(n, counts.n_instance / counts.total + 1e-4, np.float32))
    rel = jnp.asarray(rng.random(n, np.float32))
    ruv = jnp.asarray(rng.random((n, 2), np.float32))
    d = L.sample_lights(dscene, dscene.lights, counts, pos, rl, rel, ruv)
    pdf_sampled = np.asarray(L.env_lights_pdf(dscene, dscene.lights, counts, d))
    assert (pdf_sampled > 0).mean() > 0.999
    u = rng.normal(size=(n, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pdf_uniform = np.asarray(
        L.env_lights_pdf(dscene, dscene.lights, counts, jnp.asarray(u))
    )
    # importance sampling concentrates pdf mass on sampled directions
    assert pdf_sampled.mean() > pdf_uniform.mean()

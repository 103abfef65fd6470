"""Light table + sampling tests (reference semantics src/trace.jl:102-187,
968-1084)."""

import jax.numpy as jnp
import numpy as np

from julia_raytracer.render import lights as L
from julia_raytracer.render.scene_device import build_device_scene


def test_sample_discrete_matches_numpy():
    cdf = jnp.asarray(np.cumsum([1.0, 3.0, 0.5, 2.0]).astype(np.float32))
    rs = jnp.asarray(np.linspace(0, 0.999, 100, dtype=np.float32))
    offset = jnp.zeros(100, jnp.int32)
    count = jnp.full(100, 4, jnp.int32)
    got = np.asarray(L.sample_discrete(cdf, offset, count, rs))
    want = np.searchsorted(np.asarray(cdf), np.clip(np.asarray(rs) * 6.5, 0, 6.5 - 1e-5), side="right")
    np.testing.assert_array_equal(got, np.clip(want, 0, 3))


def test_sample_discrete_power_of_two_count():
    """Regression: with max_count equal to an exact power-of-two segment
    length the fixed-depth search used to run one iteration short and
    return element 0 for all of element 1's probability mass (ADVICE r1).
    Production call sites pass max_count=count (e.g. 2^21 env CDFs)."""
    for n in (2, 4, 8, 16, 1024):
        w = np.ones(n, np.float32)
        cdf = jnp.asarray(np.cumsum(w))
        rs = jnp.asarray(np.linspace(0, 0.999, 257, dtype=np.float32))
        offset = jnp.zeros(257, jnp.int32)
        count = jnp.full(257, n, jnp.int32)
        got = np.asarray(L.sample_discrete(cdf, offset, count, rs, max_count=n))
        want = np.clip(
            np.searchsorted(
                np.asarray(cdf), np.clip(np.asarray(rs) * n, 0, n - 1e-5), side="right"
            ),
            0, n - 1,
        )
        np.testing.assert_array_equal(got, want, err_msg=f"count={n}")


def test_sample_discrete_pdf():
    cdf = jnp.asarray(np.cumsum([1.0, 3.0, 0.5, 2.0]).astype(np.float32))
    for i, w in enumerate([1.0, 3.0, 0.5, 2.0]):
        got = float(L.sample_discrete_pdf(cdf, jnp.int32(0), jnp.int32(4), jnp.int32(i)))
        assert abs(got - w) < 1e-5


def test_cornellbox_light_table(cornellbox):
    dscene, config = build_device_scene(cornellbox)
    counts = config.light_counts
    assert counts.n_instance == 1  # the ceiling quad light
    assert counts.n_env == 0
    # light area: light.ply is two triangles forming ~0.38x0.38 quad
    area = float(dscene.lights.inst_area[0])
    assert 0.1 < area < 0.3
    # prim_light_area nonzero exactly on the light's 2 prims
    pla = np.asarray(dscene.lights.prim_light_area)
    assert (pla > 0).sum() == 2
    np.testing.assert_allclose(pla[pla > 0], area, rtol=1e-5)


def test_sample_lights_points_to_light(cornellbox):
    dscene, config = build_device_scene(cornellbox)
    counts = config.light_counts
    n = 256
    rng = np.random.default_rng(0)
    position = jnp.asarray(np.tile([0.0, 1.0, 0.0], (n, 1)).astype(np.float32))
    rl = jnp.asarray(rng.random(n, np.float32))
    rel = jnp.asarray(rng.random(n, np.float32))
    ruv = jnp.asarray(rng.random((n, 2), np.float32))
    d = np.asarray(L.sample_lights(dscene, dscene.lights, counts, position, rl, rel, ruv))
    # cornellbox light is the ceiling quad at y ~= 1.99 -> directions point up
    assert (d[:, 1] > 0).all()
    lens = np.linalg.norm(d, axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-5)


def test_lights_pdf_matches_analytic(cornellbox):
    """For a point directly under the square light, pdf of a direction that
    hits the light = dist^2 / (cos * area) / n_lights."""
    from julia_raytracer.render.integrator import make_intersect
    from julia_raytracer.ops.geometry import F32_MAX, RAY_EPS

    dscene, config = build_device_scene(cornellbox)
    counts = config.light_counts
    intersect = make_intersect(dscene, config)

    n = 4
    position = jnp.asarray(np.tile([0.0, 1.0, 0.0], (n, 1)).astype(np.float32))
    direction = jnp.asarray(np.tile([0.0, 1.0, 0.0], (n, 1)).astype(np.float32))
    first = intersect(
        position, direction, jnp.full(n, RAY_EPS), jnp.full(n, F32_MAX)
    )
    assert bool(first[0][0])  # straight up hits the light
    pdf = np.asarray(
        L.sample_lights_pdf(
            dscene, dscene.lights, counts, intersect, position, direction, first,
            extra_steps=2,
        )
    )
    t = float(first[4][0])
    area = float(dscene.lights.inst_area[0])
    expect = t * t / (1.0 * area) / counts.total
    np.testing.assert_allclose(pdf, expect, rtol=1e-4)

"""Differentiable-mode tests (BASELINE config 3): pixel-loss gradients
w.r.t. material albedo/emission vs finite differences, plus fixed-trip
vs while-loop equivalence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.render.diff import diff_options, make_param_loss, render_radiance
from julia_raytracer.render.integrator import TraceOptions
from julia_raytracer.render.renderer import Params, Renderer, make_trace_state


@pytest.fixture(scope="module")
def setup(cornellbox_module):
    scene = cornellbox_module
    params = Params(resolution=24, samples=1, bounces=3, sampler="path")
    r = Renderer(scene, params)
    state = make_trace_state(scene, params)
    return r, state


@pytest.fixture(scope="module")
def cornellbox_module(cornellbox):
    return cornellbox


def test_fixed_trip_equals_while_loop(setup):
    """The scan-based differentiable loop must be bit-identical to the
    while_loop (the body is fully masked)."""
    r, state = setup
    n = state.width * state.height
    pix = jnp.arange(n, dtype=jnp.int32)
    opts_w = r.options
    opts_s = diff_options(r.options, r.config)
    rad_w = render_radiance(
        r.dscene, r.config, opts_w, r.cam_arrays, state.width, state.height,
        pix, jnp.int32(0),
    )
    rad_s = render_radiance(
        r.dscene, r.config, opts_s, r.cam_arrays, state.width, state.height,
        pix, jnp.int32(0),
    )
    np.testing.assert_array_equal(np.asarray(rad_w), np.asarray(rad_s))


def test_grads_vs_finite_differences(setup):
    """d loss / d emission and d loss / d color, checked against central
    finite differences of the SAME deterministic estimator."""
    r, state = setup
    n = state.width * state.height
    pix = jnp.arange(n, dtype=jnp.int32)
    target = jnp.zeros((n, 3), jnp.float32)
    loss = make_param_loss(
        r.dscene, r.config, r.options, r.cam_arrays, state.width, state.height
    )
    loss_j = jax.jit(loss, static_argnums=(4,))

    color0 = r.dscene.materials.color
    emis0 = r.dscene.materials.emission
    g_color, g_emis = jax.jit(
        jax.grad(loss, argnums=(0, 1)), static_argnums=(4,)
    )(color0, emis0, pix, target, 2)
    g_color, g_emis = np.asarray(g_color), np.asarray(g_emis)
    assert np.isfinite(g_color).all() and np.isfinite(g_emis).all()

    # emission of the light (material 4) must have positive grad (target=0,
    # more light -> more loss); spot-check vs central differences
    rng = np.random.default_rng(0)
    checks = [(4, 1, "emission"), (0, 0, "color"), (1, 1, "color"), (4, 0, "emission")]
    for mat, chan, which in checks:
        eps = 1e-2
        def at(delta):
            c, e = np.asarray(color0).copy(), np.asarray(emis0).copy()
            if which == "color":
                c[mat, chan] += delta
            else:
                e[mat, chan] += delta
            return float(loss_j(jnp.asarray(c), jnp.asarray(e), pix, target, 2))

        fd = (at(eps) - at(-eps)) / (2 * eps)
        ad = g_color[mat, chan] if which == "color" else g_emis[mat, chan]
        np.testing.assert_allclose(
            ad, fd, rtol=0.05, atol=1e-5,
            err_msg=f"grad mismatch for {which}[{mat},{chan}]",
        )


def test_emission_grad_direction(setup):
    """Target = 2x the current render -> more light reduces loss, so the
    light's emission gradient must be negative."""
    r, state = setup
    n = state.width * state.height
    pix = jnp.arange(n, dtype=jnp.int32)
    from julia_raytracer.render.diff import diff_options, render_radiance

    rad = render_radiance(
        r.dscene, r.config, diff_options(r.options, r.config), r.cam_arrays,
        state.width, state.height, pix, jnp.int32(0),
    )
    target = 2.0 * rad
    loss = make_param_loss(
        r.dscene, r.config, r.options, r.cam_arrays, state.width, state.height
    )
    g_emis = jax.jit(jax.grad(loss, argnums=1), static_argnums=(4,))(
        r.dscene.materials.color, r.dscene.materials.emission, pix, target, 1
    )
    # light material is index 4 in cornellbox
    assert float(np.asarray(g_emis)[4].sum()) < 0

"""Differentiable rendering: pure radiance function + parameter losses.

The reference has no differentiable mode; this is the wavefront
extension defined by BASELINE.md config 3 (pixel-loss gradients w.r.t.
material albedo/emission, validated against finite differences).

Estimator: detached sampling — the integrator stop-gradients all sampled
directions and pdfs (render/integrator.py), so gradients flow through
eval_bsdfcos / eval_emission / eval_environment / texture filtering to
material, light, and camera parameters while discrete decisions
(lobe/light picks, Russian roulette, opacity) stay fixed. With the
counter-based RNG the whole pipeline is a deterministic function of its
parameters, so finite differences of the SAME seed converge to the same
gradient — the basis of the grad-allclose test.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from julia_raytracer.ops.camera import sample_camera
from julia_raytracer.render.integrator import TraceOptions, trace_wavefront
from julia_raytracer.utils import rng as rng_mod


def diff_options(
    options: TraceOptions, config=None, opacity_budget: int | None = None
) -> TraceOptions:
    """Switch an options struct to the fixed-trip (differentiable) loop.

    The while_loop path allows up to 128 stochastic-opacity skips per lane
    (src/trace.jl:356-364); a fixed-trip scan must budget iterations for
    them up front. Opacity-free scenes (config.has_opacity False) need
    none, so scan==while_loop exactly; scenes with opacity get a budget of
    32 extra trips by default — lanes that roll more skips than that are
    truncated (a documented approximation; P(>32 consecutive passthrough
    resamples) is negligible for any non-degenerate opacity)."""
    if opacity_budget is None:
        has_op = bool(getattr(config, "has_opacity", True)) if config is not None else True
        opacity_budget = 32 if has_op else 0
    return options._replace(
        fixed_iterations=options.bounces + 1 + opacity_budget
    )


def render_radiance(
    dscene,
    config,
    options: TraceOptions,
    cam,
    width: int,
    height: int,
    pixel_ids,
    sample_id,
    seed: int = 0,
    tentfilter: bool = False,
):
    """One radiance sample per pixel lane — pure and differentiable w.r.t.
    every float leaf of `dscene` (materials, textures, env, geometry)."""
    rng = rng_mod.seed_state(pixel_ids, sample_id, seed)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = jnp.stack([pixel_ids % width, pixel_ids // width], axis=-1)
    ro, rd = sample_camera(cam, ij, (width, height), puv, luv, tentfilter)
    radiance, hit, albedo, normal, _ = trace_wavefront(
        dscene, config, options, ro, rd, rng
    )
    finite = jnp.all(jnp.isfinite(radiance), axis=-1)
    return jnp.where(finite[..., None], radiance, 0.0)


def render_radiance_mean(
    dscene, config, options, cam, width, height, pixel_ids,
    n_samples: int, seed: int = 0, tentfilter: bool = False,
):
    """Average of `n_samples` radiance samples (scan over sample ids)."""
    def one(carry, sample_id):
        acc = carry
        r = render_radiance(
            dscene, config, options, cam, width, height, pixel_ids,
            sample_id, seed, tentfilter,
        )
        return acc + r, None

    init = jnp.zeros(pixel_ids.shape + (3,), jnp.float32)
    total, _ = jax.lax.scan(one, init, jnp.arange(n_samples, dtype=jnp.int32))
    return total / n_samples


def make_param_loss(dscene, config, options, cam, width, height):
    """Returns loss(color, emission, pixel_ids, target, n_samples) — the
    BASELINE config-3 objective: mean squared pixel error as a function of
    the material color (albedo) and emission tables."""
    d_opts = diff_options(options, config)

    def loss(mat_color, mat_emission, pixel_ids, target, n_samples, seed=0):
        mats = dscene.materials._replace(color=mat_color, emission=mat_emission)
        d = dscene._replace(materials=mats)
        img = render_radiance_mean(
            d, config, d_opts, cam, width, height, pixel_ids, n_samples, seed
        )
        return jnp.mean((img - target) ** 2)

    return loss

"""AOV-guided denoiser: edge-avoiding à-trous wavelet filtering.

The reference accepts ``--denoise`` but stubs it out with a warning
(src/jtrace.jl:35-46) even though it accumulates the albedo/normal AOV
buffers a denoiser would need (src/trace.jl:94-96, 631-648). This module
makes the flag real — a capability the reference ships the plumbing for
but never implements.

Design:
- Dammertz et al. 2010 "Edge-Avoiding À-Trous Wavelet Transform for Fast
  Global Illumination Filtering": N passes of a 5x5 B3-spline kernel with
  exponentially growing tap spacing (1, 2, 4, ...), each tap reweighted by
  edge-stopping functions on the guide AOVs (shading normal, albedo) and
  on filtered luminance.
- Each pass is 25 statically-shifted multiply-accumulates over the [H, W]
  image — XLA fuses the whole pass into one elementwise loop over device
  memory (pad + static slices, no gathers, no data-dependent control
  flow), so a pass costs ~25 reads of the image, small next to one
  sample's path tracing. No hand-written kernel is needed.
- Illumination is demodulated by albedo before filtering and remodulated
  after, so texture detail never blurs; only the noisy light transport is
  smoothed (standard SVGF-style split).

Determinism: pure function of the accumulation buffers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from julia_raytracer.utils.color import luminance

# 1-D B3-spline coefficients; the 5x5 kernel is their outer product.
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _box3(x):
    """3x3 edge-replicated box mean of [H, W]."""
    H, W = x.shape
    xp = jnp.pad(x, ((1, 1), (1, 1)), mode="edge")
    acc = jnp.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            acc = acc + jax.lax.slice(xp, (dy, dx), (dy + H, dx + W))
    return acc / 9.0


def _atrous_pass(illum, albedo, normal, step: int,
                 sigma_l: float, sigma_n: float, sigma_a: float):
    """One à-trous pass at tap spacing `step`. All inputs [H, W, C]."""
    H, W = illum.shape[0], illum.shape[1]
    p = 2 * step
    pad = partial(jnp.pad, pad_width=((p, p), (p, p), (0, 0)), mode="edge")
    il_p, al_p, nr_p = pad(illum), pad(albedo), pad(normal)

    lum_c = luminance(illum)
    # SVGF-style noise-adaptive luminance sigma: normalize the luminance
    # difference by a local (3x3) variance estimate, so Monte-Carlo noise
    # (high local variance) smooths aggressively while converged regions
    # keep their shading edges (shadow boundaries, caustics).
    var_l = jnp.maximum(_box3(lum_c * lum_c) - _box3(lum_c) ** 2, 0.0)
    denom = sigma_l * jnp.sqrt(var_l) + 1e-4
    acc = jnp.zeros_like(illum)
    wsum = jnp.zeros((H, W, 1), jnp.float32)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            k = _B3[dy + 2] * _B3[dx + 2]
            oy, ox = p + dy * step, p + dx * step
            il_s = jax.lax.slice(il_p, (oy, ox, 0), (oy + H, ox + W, 3))
            al_s = jax.lax.slice(al_p, (oy, ox, 0), (oy + H, ox + W, 3))
            nr_s = jax.lax.slice(nr_p, (oy, ox, 0), (oy + H, ox + W, 3))
            # edge-stopping: luminance (keeps shadow/caustic edges),
            # normal (geometric edges), albedo (material/texture edges)
            w_l = jnp.exp(-jnp.abs(lum_c - luminance(il_s)) / denom)
            ndot = jnp.maximum(jnp.sum(normal * nr_s, axis=-1), 0.0)
            w_n = ndot ** sigma_n
            da = jnp.sum((albedo - al_s) ** 2, axis=-1)
            w_a = jnp.exp(-da / sigma_a)
            w = (k * w_l * w_n * w_a)[..., None]
            acc = acc + w * il_s
            wsum = wsum + w
    return acc / jnp.maximum(wsum, 1e-8)


@partial(jax.jit, static_argnames=("width", "height", "iterations"))
def denoise_image(image, albedo, normal, width: int, height: int,
                  iterations: int = 5, sigma_l: float = 4.0,
                  sigma_n: float = 64.0, sigma_a: float = 0.02):
    """Denoise the accumulated radiance using the albedo/normal AOVs.

    image [P, 4] (rgb + alpha), albedo [P, 3], normal [P, 3] — the
    TraceState accumulation buffers, flat pixel-major. P may exceed
    height*width: trace_samples pads the accumulation buffers to a chunk
    multiple when a frame spans several chunks, so slice to the real
    pixel count before reshaping. Returns a denoised [height*width, 4];
    alpha passes through untouched (get_image re-slices to n_pixels).
    """
    n = height * width
    image = image[:n]
    rgb = image[:, 0:3].reshape(height, width, 3)
    alb = albedo[:n].reshape(height, width, 3)
    nrm = normal[:n].reshape(height, width, 3)
    # Zero-normal pixels (pure env/miss) get a unit dummy so w_n compares
    # miss-vs-miss as similar instead of 0**sigma everywhere.
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = jnp.where(nlen > 1e-6, nrm / jnp.maximum(nlen, 1e-6),
                    jnp.array([0.0, 0.0, 1.0], jnp.float32))
    # Demodulate texture detail; miss pixels (albedo ~ 0) are left as-is.
    demod = alb > 1e-3
    illum = jnp.where(demod, rgb / jnp.maximum(alb, 1e-3), rgb)

    for i in range(iterations):
        illum = _atrous_pass(illum, alb, nrm, 1 << i, sigma_l, sigma_n, sigma_a)

    out_rgb = jnp.where(demod, illum * alb, illum).reshape(-1, 3)
    return jnp.concatenate([out_rgb, image[:, 3:4]], axis=1)

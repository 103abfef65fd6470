"""sRGB <-> linear conversions (exact piecewise curve) and byte packing.

Mirrors the reference color layer (src/color.jl). Works on both numpy and
jnp arrays (pure ufunc math), applying the curve to the first three
channels of RGBA data and passing alpha through.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def srgb_to_rgb_scalar(c):
    """Piecewise sRGB decode (src/color.jl:175-179)."""
    xp = jnp if isinstance(c, jnp.ndarray) else np
    return xp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def rgb_to_srgb_scalar(c):
    """Piecewise sRGB encode (src/color.jl:185-186)."""
    xp = jnp if isinstance(c, jnp.ndarray) else np
    safe = xp.where(c > 0.0031308, c, 1.0)
    return xp.where(c <= 0.0031308, 12.92 * c, 1.055 * safe ** (1.0 / 2.4) - 0.055)


def srgb_to_rgb(rgba):
    """Decode rgb channels, alpha passthrough (src/color.jl:172-173)."""
    xp = jnp if isinstance(rgba, jnp.ndarray) else np
    return xp.concatenate([srgb_to_rgb_scalar(rgba[..., :3]), rgba[..., 3:]], axis=-1)


def rgb_to_srgb(rgba):
    xp = jnp if isinstance(rgba, jnp.ndarray) else np
    return xp.concatenate([rgb_to_srgb_scalar(rgba[..., :3]), rgba[..., 3:]], axis=-1)


def byte_to_float(b):
    return b.astype(np.float32) / 255.0


def float_to_byte(f):
    """trunc(f * 256) clamped to [0, 255] (src/color.jl:188-193)."""
    xp = jnp if isinstance(f, jnp.ndarray) else np
    return xp.clip(xp.trunc(f * 256.0), 0, 255).astype(xp.uint8)


def luminance(rgb):
    """Rec. 709 luminance of [..., 3] linear RGB, as elementwise
    multiply-adds (a float32 dot may run in TF32 on a GPU)."""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]

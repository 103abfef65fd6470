"""Texture atlas sampling (bilinear, wrap-repeat) on flat device arrays.

All scene textures live in ONE flat [sum(w*h), 4] array; per-texture
metadata (offset/width/height/linear) is gathered per lane by texture id.
Semantics match eval_texture/lookup_texture (src/scene.jl:790-849):
  - wrap via mod1 (uv==integer maps to 1.0, not 0.0 — preserved exactly),
  - bilinear 4-tap with per-tap sRGB decode for byte textures when the
    caller wants linear values (`as_linear`),
  - texture id -1 -> white (src/scene.jl:683-688),
  - zero-size texture -> zeros (src/scene.jl:797-799).

The 4 taps are gathers from device memory, batched across the wavefront
so XLA vectorizes the index math; all decode work is branchless.
"""

from __future__ import annotations

import jax.numpy as jnp

from julia_raytracer.utils.color import srgb_to_rgb


def _mod1(x, m):
    """Julia mod1: result in (0, m], i.e. x==k*m maps to m (src/scene.jl:809)."""
    r = jnp.mod(x, m)
    return jnp.where(r == 0.0, m, r)


def eval_texture(tex, texture_id, uv, as_linear, no_interpolation=False):
    """Sample texture `texture_id` ([N] i32) at uv ([N, 2]) -> [N, 4].

    `tex` is scene.flatten.FlatTextures as jnp arrays. texture_id == -1
    returns white.
    """
    n_tex = tex.width.shape[0]
    if n_tex == 0:
        return jnp.ones(uv.shape[:-1] + (4,), jnp.float32)

    valid = texture_id >= 0
    tid = jnp.clip(texture_id, 0, n_tex - 1)
    width = tex.width[tid]
    height = tex.height[tid]
    offset = tex.offset[tid]
    linear = tex.linear[tid]
    wf = width.astype(jnp.float32)
    hf = height.astype(jnp.float32)

    # wrap-repeat in [0, size] (mod1 semantics, src/scene.jl:808-816)
    s = _mod1(uv[..., 0], 1.0) * wf
    t = _mod1(uv[..., 1], 1.0) * hf
    s = jnp.where(s < 0, s + wf, s)
    t = jnp.where(t < 0, t + hf, t)

    i = jnp.clip(s.astype(jnp.int32), 0, width - 1)
    j = jnp.clip(t.astype(jnp.int32), 0, height - 1)
    ii = jnp.where(i + 1 >= width, 0, i + 1)
    jj = jnp.where(j + 1 >= height, 0, j + 1)
    u = s - i.astype(jnp.float32)
    v = t - j.astype(jnp.float32)

    def lookup(x, y):
        idx = offset + y * width + x
        color = tex.data[jnp.clip(idx, 0, tex.data.shape[0] - 1)]
        if as_linear:
            # byte textures store raw sRGB; decode on tap (src/scene.jl:848)
            return jnp.where(linear[..., None], color, srgb_to_rgb(color))
        return color

    if no_interpolation:
        out = lookup(i, j)
    else:
        out = (
            lookup(i, j) * ((1 - u) * (1 - v))[..., None]
            + lookup(i, jj) * ((1 - u) * v)[..., None]
            + lookup(ii, j) * (u * (1 - v))[..., None]
            + lookup(ii, jj) * (u * v)[..., None]
        )

    # missing texture -> white; zero-size -> zeros (src/scene.jl:683-688,797-799)
    empty = (width == 0) | (height == 0)
    out = jnp.where(empty[..., None], 0.0, out)
    return jnp.where(valid[..., None], out, 1.0)


def lookup_texel(tex, texture_id, i, j, as_linear=False):
    """Single-texel lookup by integer coords (src/scene.jl:836-849)."""
    tid = jnp.clip(texture_id, 0, tex.width.shape[0] - 1)
    idx = tex.offset[tid] + j * tex.width[tid] + i
    color = tex.data[jnp.clip(idx, 0, tex.data.shape[0] - 1)]
    if as_linear:
        return jnp.where(tex.linear[tid][..., None], color, srgb_to_rgb(color))
    return color

"""Vector/frame math on batched arrays.

All functions operate on float32 arrays whose last axis is the vector
dimension ([..., 3] for vectors, [..., 4, 3] for frames) so that the same
code runs per-lane across a whole ray wavefront. Semantics mirror the
reference math layer (reference: src/math.jl) but are written jnp-first so
XLA fuses them into the surrounding kernels.

A *frame* is a rigid (or affine) transform stored as 4 row vectors:
rows 0..2 are the x/y/z axes, row 3 is the origin (src/math.jl:46-61).
"""

from __future__ import annotations

import jax.numpy as jnp

IDENTITY_FRAME = jnp.array(
    [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]], dtype=jnp.float32
)


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def dot_keep(a, b):
    return jnp.sum(a * b, axis=-1, keepdims=True)


def cross(a, b):
    return jnp.cross(a, b)


def length(a):
    # double-where: finite gradient at |a| == 0 (0 * inf guard for autodiff)
    d = dot(a, a)
    pos = d > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, d, 1.0)), 0.0)


def distance_squared(a, b):
    d = a - b
    return dot(d, d)


def normalize(a):
    """Zero-safe normalize: returns `a` unchanged when |a| == 0 (src/math.jl:71-78)."""
    l = length(a)[..., None]
    return jnp.where(l != 0, a / jnp.where(l == 0, 1.0, l), a)


def orthonormalize(a, b):
    return normalize(a - b * dot_keep(a, b))


def lerp(a, b, u):
    return a * (1.0 - u) + b * u


def reflect(w, n):
    return -w + 2.0 * dot_keep(n, w) * n


def refract(w, n, inv_eta):
    """Refraction; returns 0 on total internal reflection (src/math.jl:133-140).

    `inv_eta` may be scalar or batched [...] (one per lane)."""
    inv_eta = jnp.asarray(inv_eta, jnp.float32)
    if inv_eta.ndim == w.ndim - 1:
        inv_eta = inv_eta[..., None]
    cosine = dot_keep(n, w)
    k = 1.0 + inv_eta * inv_eta * (cosine * cosine - 1.0)
    refr = -w * inv_eta + (inv_eta * cosine - jnp.sqrt(jnp.maximum(k, 0.0))) * n
    return jnp.where(k >= 0.0, refr, jnp.zeros_like(w))


# ---------------------------------------------------------------------------
# Frames ([..., 4, 3]: rows x, y, z, origin)
# ---------------------------------------------------------------------------


def make_frame(x, y, z, o):
    return jnp.stack([x, y, z, o], axis=-2)


def frame_rotation(frame):
    return frame[..., :3, :]


def mat_mul_vec(m, v):
    """Column-major product m[0]*v0 + m[1]*v1 + m[2]*v2 (src/math.jl:105).

    Written as elementwise multiply-adds, not a dot: a float32 dot may run
    in TF32 on a GPU, and a ray origin off by ~1e-3 of the scene scale
    self-intersects."""
    return (m[..., 0, :] * v[..., 0:1] + m[..., 1, :] * v[..., 1:2]
            + m[..., 2, :] * v[..., 2:3])


def transform_point(frame, p):
    """(x*p0 + y*p1 + z*p2) + o (src/math.jl:80-81)."""
    return mat_mul_vec(frame[..., :3, :], p) + frame[..., 3, :]


def transform_vector(frame_or_mat, v):
    return mat_mul_vec(frame_or_mat[..., :3, :], v)


def transform_direction(frame_or_mat, v):
    return normalize(transform_vector(frame_or_mat, v))


def transform_normal(frame, n, non_rigid: bool = False):
    """src/math.jl:124-125: rigid frames rotate+normalize directly."""
    if non_rigid:
        return transform_direction(frame_rotation(frame), n)
    return transform_direction(frame, n)


def mat_transpose(m):
    return jnp.swapaxes(m, -1, -2)


def mat_determinant(m):
    return dot(m[..., 0, :], cross(m[..., 1, :], m[..., 2, :]))


def mat_adjoint(m):
    """Adjugate as used by the reference (src/math.jl:109-110)."""
    rows = jnp.stack(
        [
            cross(m[..., 1, :], m[..., 2, :]),
            cross(m[..., 2, :], m[..., 0, :]),
            cross(m[..., 0, :], m[..., 1, :]),
        ],
        axis=-2,
    )
    return mat_transpose(rows)


def mat_inverse(m):
    det = mat_determinant(m)[..., None, None]
    return mat_adjoint(m) * (1.0 / det)


def frame_inverse(frame, non_rigid: bool = False):
    """Invert a frame; rigid path uses the transpose (src/math.jl:95-103)."""
    rot = frame_rotation(frame)
    minv = mat_inverse(rot) if non_rigid else mat_transpose(rot)
    o = -mat_mul_vec(minv, frame[..., 3, :])
    return jnp.concatenate([minv, o[..., None, :]], axis=-2)


def lookat_frame(eye, center, up, inv_xz: bool = False):
    """Camera/instance lookat frame (src/math.jl:146-155)."""
    w = normalize(eye - center)
    u = normalize(cross(up, w))
    v = normalize(cross(w, u))
    if inv_xz:
        w = -w
        u = -u
    return make_frame(u, v, w, eye)


def select_rows(table, ids, size: int):
    """Gather-free small-table lookup: table [M, K] (or [M]) indexed by
    ids [N] -> [N, K] via an unrolled compare-select chain.

    For M <= ~64 this compiles to M elementwise selects instead of a
    per-lane gather. `size` must be the static M."""
    vec = table.ndim == 2
    out = jnp.zeros(
        ids.shape + ((table.shape[1],) if vec else ()), table.dtype
    )
    for m in range(size):
        mask = ids == m
        row = table[m]
        out = jnp.where(mask[..., None] if vec else mask, row, out)
    return out


def basis_fromz(v):
    """Branchless ONB (Duff et al.); returns [..., 3, 3] (src/shading.jl:724-732)."""
    z = normalize(v)
    sign = jnp.where(z[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z[..., 2])
    b = z[..., 0] * z[..., 1] * a
    x = jnp.stack(
        [1.0 + sign * z[..., 0] * z[..., 0] * a, sign * b, -sign * z[..., 0]], axis=-1
    )
    y = jnp.stack([b, sign + z[..., 1] * z[..., 1] * a, -z[..., 1]], axis=-1)
    return jnp.stack([x, y, z], axis=-2)

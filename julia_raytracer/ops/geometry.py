"""Ray-primitive intersection + interpolation (vectorized jnp).

Semantics match the reference geometry layer exactly (src/geometry.jl),
including the slab-test robustness factor `t1 *= 1.00000024`
(src/geometry.jl:103) and the quad = two-triangles-with-flipped-second-uv
convention (src/geometry.jl:238-258). Everything is branchless and
batched over an arbitrary leading ray axis so it runs as wavefront
elementwise work under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

from julia_raytracer.utils.vecmath import cross, dot, normalize

RAY_EPS = 1e-4  # src/geometry.jl:34
F32_MAX = jnp.float32(3.4028235e38)


def intersect_bbox(ro, rdinv, tmin, tmax, bb_min, bb_max):
    """Slab test (src/geometry.jl:96-105). Returns (hit, t_enter)."""
    it_min = (bb_min - ro) * rdinv
    it_max = (bb_max - ro) * rdinv
    lo = jnp.minimum(it_min, it_max)
    hi = jnp.maximum(it_min, it_max)
    t0 = jnp.maximum(jnp.max(lo, axis=-1), tmin)
    t1 = jnp.minimum(jnp.min(hi, axis=-1), tmax) * jnp.float32(1.00000024)
    return t0 <= t1, t0


def intersect_triangle(ro, rd, tmin, tmax, p1, p2, p3):
    """Moller-Trumbore (src/geometry.jl:206-236) -> (hit, u, v, t)."""
    edge1 = p2 - p1
    edge2 = p3 - p1
    pvec = cross(rd, edge2)
    det = dot(edge1, pvec)
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    tvec = ro - p1
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = dot(rd, qvec) * inv_det
    t = dot(edge2, qvec) * inv_det
    hit = (
        (det != 0.0)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= tmin)
        & (t <= tmax)
    )
    return hit, u, v, t


def intersect_quad(ro, rd, tmin, tmax, p1, p2, p3, p4):
    """Quad as (p1,p2,p4)+(p3,p4,p2), second uv flipped (src/geometry.jl:238-258).

    Degenerate quads (p3 == p4, our embedded triangles) fall out naturally:
    the second triangle has det == 0 and never hits. Returns (hit, u, v, t).
    """
    h1, u1, v1, t1 = intersect_triangle(ro, rd, tmin, tmax, p1, p2, p4)
    h2, u2, v2, t2 = intersect_triangle(ro, rd, tmin, tmax, p3, p4, p2)
    t1 = jnp.where(h1, t1, F32_MAX)
    t2 = jnp.where(h2, t2, F32_MAX)
    first = t1 < t2
    hit = h1 | h2
    u = jnp.where(first, u1, 1.0 - u2)
    v = jnp.where(first, v1, 1.0 - v2)
    t = jnp.where(first, t1, t2)
    return hit, u, v, t


def intersect_point(ro, rd, tmin, tmax, p, r):
    """Ray vs radius-point (src/geometry.jl:113-128) -> (hit, t)."""
    w = p - ro
    t = dot(w, rd) / dot(rd, rd)
    rp = ro + rd * t[..., None]
    prp = p - rp
    hit = (t >= tmin) & (t <= tmax) & (dot(prp, prp) <= r * r)
    return hit, t


def intersect_line(ro, rd, tmin, tmax, p1, p2, r1, r2):
    """Ray vs line segment with radius (src/geometry.jl:130-172) -> (hit,u,v,t)."""
    u_ = rd
    v_ = p2 - p1
    w_ = ro - p1
    a = dot(u_, u_)
    b = dot(u_, v_)
    c = dot(v_, v_)
    d = dot(u_, w_)
    e = dot(v_, w_)
    det = a * c - b * b
    safe = jnp.where(det == 0.0, 1.0, det)
    t = (b * e - c * d) / safe
    s = jnp.clip((a * e - b * d) / safe, 0.0, 1.0)
    pr = ro + rd * t[..., None]
    pl = p1 + (p2 - p1) * s[..., None]
    prl = pr - pl
    d2 = dot(prl, prl)
    r = r1 * (1.0 - s) + r2 * s
    hit = (det != 0.0) & (t >= tmin) & (t <= tmax) & (d2 <= r * r)
    return hit, s, jnp.sqrt(d2) / jnp.where(r == 0, 1.0, r), t


def interpolate_triangle(p1, p2, p3, u, v):
    w = (1.0 - u - v)[..., None]
    return p1 * w + p2 * u[..., None] + p3 * v[..., None]


def interpolate_quad(p1, p2, p3, p4, u, v):
    """Bilinear-ish quad interpolation via the two-triangle convention
    (src/geometry.jl:278-283)."""
    lower = u + v <= 1.0
    a = interpolate_triangle(p1, p2, p4, u, v)
    b = interpolate_triangle(p3, p4, p2, 1.0 - u, 1.0 - v)
    return jnp.where(lower[..., None], a, b)


def interpolate_quad2(p1, p2, p3, p4, u, v):
    """Same for 2-vector attributes."""
    return interpolate_quad(p1, p2, p3, p4, u, v)


def triangle_normal(p1, p2, p3):
    return normalize(cross(p2 - p1, p3 - p1))


def triangle_area(p1, p2, p3):
    c = cross(p2 - p1, p3 - p1)
    return jnp.sqrt(dot(c, c)) * 0.5


def quad_normal(p1, p2, p3, p4):
    """normalize(n(p1,p2,p4) + n(p3,p4,p2)) (src/geometry.jl:267-268)."""
    return normalize(triangle_normal(p1, p2, p4) + triangle_normal(p3, p4, p2))


def quad_area(p1, p2, p3, p4):
    return triangle_area(p1, p2, p4) + triangle_area(p3, p4, p2)


def triangle_tangents_fromuv(p1, p2, p3, uv1, uv2, uv3):
    """UV-aligned tangent pair (src/geometry.jl:285-316) -> (tu, tv)."""
    p = p2 - p1
    q = p3 - p1
    s0 = uv2[..., 0] - uv1[..., 0]
    s1 = uv3[..., 0] - uv1[..., 0]
    t0 = uv2[..., 1] - uv1[..., 1]
    t1 = uv3[..., 1] - uv1[..., 1]
    div = s0 * t1 - s1 * t0
    safe = jnp.where(div == 0.0, 1.0, div)[..., None]
    tu = (t1[..., None] * p - t0[..., None] * q) / safe
    tv = (s0[..., None] * q - s1[..., None] * p) / safe
    ok = (div != 0.0)[..., None]
    dflt_u = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], jnp.float32), tu.shape)
    dflt_v = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], jnp.float32), tv.shape)
    return jnp.where(ok, tu, dflt_u), jnp.where(ok, tv, dflt_v)

"""Dense closest-hit kernel for small scenes, Pallas through Triton.

One program per block of BLOCK rays. Every program reads the scene's
prims from one [16, Qpad] table and loops over them keeping the running
closest t and prim id in registers, so none of the [rays x prims]
intermediates that `intersect_bruteforce` materialises reach device
memory. The arithmetic is `geometry.intersect_quad`'s, and ties keep the
lower prim id, as in `intersect_bruteforce`.

The kernel only picks the prim. `intersect_dense` recomputes u, v and t
for that prim with `intersect_quad` in plain JAX, so the hit record is
differentiable in the ray exactly like the brute-force one, and no
gradient rule is needed for the kernel (its inputs are stop_gradient'ed:
the closest-prim choice is piecewise constant).

On the GPU the prim choice runs this kernel; on any other backend (the
CPU tests) it is `intersect_bruteforce`'s own argmin (`bruteforce_prim`),
through `lax.platform_dependent`, which picks per lowering platform. Tests run
the kernel itself on the CPU with interpret=True.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from julia_raytracer.ops.geometry import F32_MAX, intersect_quad
from julia_raytracer.ops.traversal import Hit, hit_surface, intersect_bruteforce

BLOCK = 256  # rays per program of the kernel
_FMAX = 3.4028235e38  # a Python float: kernels may not capture arrays


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _triangle(o, d, tmin, tmax, p1, p2, p3):
    """Moller-Trumbore on SoA tuples (geometry.intersect_triangle)."""
    e1 = tuple(p2[k] - p1[k] for k in range(3))
    e2 = tuple(p3[k] - p1[k] for k in range(3))
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
    tvec = tuple(o[k] - p1[k] for k in range(3))
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ((det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
           & (u + v <= 1.0) & (t >= tmin) & (t <= tmax))
    return hit, t


def _kernel(n_prims, rays_ref, prims_ref, prim_ref):
    o = (rays_ref[0, :], rays_ref[1, :], rays_ref[2, :])
    d = (rays_ref[3, :], rays_ref[4, :], rays_ref[5, :])
    tmin, tmax = rays_ref[6, :], rays_ref[7, :]

    def body(q, carry):
        bt, bp = carry
        c = [prims_ref[k, q] for k in range(12)]
        p1, p2, p3, p4 = (tuple(c[3 * j:3 * j + 3]) for j in range(4))
        h1, t1 = _triangle(o, d, tmin, tmax, p1, p2, p4)
        h2, t2 = _triangle(o, d, tmin, tmax, p3, p4, p2)
        t = jnp.minimum(jnp.where(h1, t1, _FMAX), jnp.where(h2, t2, _FMAX))
        better = (h1 | h2) & (t < bt)
        return jnp.where(better, t, bt), jnp.where(better, q, bp)

    init = (jnp.full(tmin.shape, _FMAX, jnp.float32),
            jnp.full(tmin.shape, -1, jnp.int32))
    _, bp = jax.lax.fori_loop(0, n_prims, body, init)
    prim_ref[...] = bp


def prim_table(prim_verts) -> jnp.ndarray:
    """[Q, 4, 3] quads -> the kernel's [16, Qpad] SoA table."""
    q = prim_verts.shape[0]
    q_pad = max(16, 1 << (q - 1).bit_length())
    tab = jnp.reshape(prim_verts, (q, 12)).T
    return jnp.pad(tab, ((0, 4), (0, q_pad - q)))


def triton_prim(prim_verts, ro, rd, tmin, tmax, interpret: bool = False):
    """Closest prim id per ray (-1 on a miss), by the Triton kernel."""
    n = ro.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    rays = jnp.concatenate(
        [ro.T, rd.T, tmin[None], tmax[None]], axis=0).astype(jnp.float32)
    # padded lanes are zero rays (det == 0), which never hit
    rays = jnp.pad(rays, ((0, 0), (0, n_pad - n)))
    tab = prim_table(prim_verts)
    prim = pl.pallas_call(
        functools.partial(_kernel, prim_verts.shape[0]),
        out_shape=jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        grid=(n_pad // BLOCK,),
        in_specs=[pl.BlockSpec((8, BLOCK), lambda i: (0, i)),
                  pl.BlockSpec(tab.shape, lambda i: (0, 0))],
        out_specs=pl.BlockSpec((BLOCK,), lambda i: (i,)),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="dense_intersect",
    )(rays, tab)
    return prim[:n]


def bruteforce_prim(prim_verts, ro, rd, tmin, tmax):
    """Closest prim id per ray (-1 on a miss): `intersect_bruteforce`'s
    choice, as XLA compiles it."""
    h = intersect_bruteforce(prim_verts, ro, rd, tmin, tmax)
    return jnp.where(h.hit, h.prim, -1)


def intersect_dense(prim_verts, ro, rd, tmin, tmax, prim_instance=None,
                    interpret: bool | None = None):
    """Drop-in for `intersect_bruteforce` (same Hit, same tie rule).

    interpret=None picks per lowering platform: the Triton kernel on the
    GPU, `bruteforce_prim` elsewhere; True/False force the kernel in
    interpret/compiled mode."""
    with jax.named_scope("dense_intersect"):
        args = [jax.lax.stop_gradient(a) for a in (prim_verts, ro, rd, tmin, tmax)]
        if interpret is None:
            prim = jax.lax.platform_dependent(
                *args, default=bruteforce_prim, cuda=triton_prim)
        else:
            prim = triton_prim(*args, interpret=interpret)
        hit = prim >= 0
        safe = jnp.maximum(prim, 0)
        v = prim_verts[safe]
        _, u, vv, t = intersect_quad(ro, rd, tmin, tmax,
                                     v[:, 0], v[:, 1], v[:, 2], v[:, 3])
        t = jnp.where(hit, t, F32_MAX)
        pos, gn = hit_surface(prim_verts, safe, u, vv)
        inst = (prim_instance[safe] if prim_instance is not None
                else jnp.zeros_like(prim))
        return Hit(hit, safe, u, vv, t, pos, gn, inst)

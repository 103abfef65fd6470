"""Wavefront BVH traversal + brute-force intersector (pure JAX).

Wavefront design: the reference walks a two-level BVH recursively per ray
with heap-allocated stacks (src/bvh.jl:306-491). Here the whole ray
wavefront advances in lock-step inside one `lax.while_loop`; each lane
keeps a short register stack (depth 48 covers median-split trees of >10^9
prims; the reference itself found depth 32 sufficient, report
§Optimizations). Internal nodes store both children's bboxes inline, so
one step costs a single 16-float gather per lane; child visit order is
near-first by actual slab entry distance (better than the reference's
per-axis sign ordering and free, since the slab t is already computed).

Tiny scenes skip the BVH entirely: a dense [rays x prims] intersect is
elementwise work with zero gathers, which XLA fuses into the argmin.

Both intersectors run under a named scope ("bruteforce_intersect",
"bvh_traversal"), so a profiler trace can attribute device time to them.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from julia_raytracer.ops.geometry import (
    F32_MAX,
    intersect_bbox,
    intersect_quad,
    interpolate_quad,
    quad_normal,
)

STACK_DEPTH = 48
LEAF_UNROLL = 4  # matches builder leaf size


class Hit(NamedTuple):
    """Closest-hit record. `position` is the interpolated surface point
    (eval_position semantics, src/scene.jl:435-476) and `gnormal` the
    uv-independent element normal (eval_element_normal,
    src/scene.jl:578-612) — both computed inside the intersector so
    shading needs no [N,4,3] vertex gather on the hot path."""

    hit: jnp.ndarray  # bool [N]
    prim: jnp.ndarray  # i32 [N]
    u: jnp.ndarray  # f32 [N]
    v: jnp.ndarray  # f32 [N]
    t: jnp.ndarray  # f32 [N]
    position: jnp.ndarray  # f32 [N, 3]
    gnormal: jnp.ndarray  # f32 [N, 3]
    instance: jnp.ndarray  # i32 [N] owning instance, gathered once per
    # intersect so shading needs no prim_instance gather


def hit_surface(prim_verts, prim, u, v):
    """(position, gnormal) for hit records via vertex gather (the jnp
    shared by both intersectors)."""
    verts = prim_verts[jnp.clip(prim, 0, prim_verts.shape[0] - 1)]
    p1, p2, p3, p4 = (verts[..., k, :] for k in range(4))
    position = interpolate_quad(p1, p2, p3, p4, u, v)
    return position, quad_normal(p1, p2, p3, p4)


def intersect_bruteforce(prim_verts, ro, rd, tmin, tmax, prim_mask=None,
                         prim_instance=None):
    """Dense all-prims intersection. prim_verts: [Q,4,3]; rays: [N,3].

    Returns (hit [N], prim [N] i32, u, v, t). Closest hit wins; ties keep
    the lower prim index (matches serial traversal order).
    """
    with jax.named_scope("bruteforce_intersect"):
        return _intersect_bruteforce(prim_verts, ro, rd, tmin, tmax,
                                     prim_mask, prim_instance)


def _intersect_bruteforce(prim_verts, ro, rd, tmin, tmax, prim_mask,
                          prim_instance):
    q = prim_verts.shape[0]
    p = prim_verts[None]  # [1,Q,4,3]
    ro_ = ro[:, None]
    rd_ = rd[:, None]
    h, u, v, t = intersect_quad(
        ro_, rd_, tmin[:, None], tmax[:, None],
        p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :],
    )
    if prim_mask is not None:
        h = h & prim_mask[None]
    t = jnp.where(h, t, F32_MAX)
    best = jnp.argmin(t, axis=1)
    n = jnp.arange(ro.shape[0])
    hit = h[n, best]
    prim = best.astype(jnp.int32)
    bu, bv, bt = u[n, best], v[n, best], t[n, best]
    pos, gn = hit_surface(prim_verts, prim, bu, bv)
    inst = (
        prim_instance[prim] if prim_instance is not None
        else jnp.zeros_like(prim)
    )
    return Hit(hit, prim, bu, bv, bt, pos, gn, inst)


@partial(jax.jit, static_argnames=("find_any",))
def intersect_bvh(nodes, prim_verts, ro, rd, tmin, tmax, find_any: bool = False,
                  prim_instance=None):
    """Traverse packed BVH nodes for a ray wavefront.

    nodes: f32 [Nn, 16] (see ops/bvh.py); prim_verts: f32 [Q, 4, 3] in
    leaf order. Rays: ro/rd [N, 3], tmin/tmax [N].
    Returns (hit [N] bool, prim [N] i32, u [N], v [N], t [N]).
    """
    with jax.named_scope("bvh_traversal"):
        return _intersect_bvh(nodes, prim_verts, ro, rd, tmin, tmax,
                              find_any, prim_instance)


def _intersect_bvh(nodes, prim_verts, ro, rd, tmin, tmax, find_any,
                   prim_instance):
    n = ro.shape[0]
    rdinv = 1.0 / rd

    # per-lane state
    stack = jnp.zeros((n, STACK_DEPTH), jnp.int32)
    sp = jnp.zeros(n, jnp.int32)
    current = jnp.zeros(n, jnp.int32)  # root
    active = jnp.ones(n, bool)
    best_t = tmax
    best_prim = jnp.full(n, -1, jnp.int32)
    best_u = jnp.zeros(n, jnp.float32)
    best_v = jnp.zeros(n, jnp.float32)

    child_ids_f = nodes[:, 12:14]

    def step(state):
        stack, sp, current, active, best_t, best_prim, best_u, best_v = state

        is_internal = current >= 0
        node_idx = jnp.where(is_internal, current, 0)
        row = nodes[node_idx]  # [N, 16] single gather
        child = jax.lax.bitcast_convert_type(row[:, 12:14], jnp.int32)

        hitL, tL = intersect_bbox(ro, rdinv, tmin, best_t, row[:, 0:3], row[:, 3:6])
        hitR, tR = intersect_bbox(ro, rdinv, tmin, best_t, row[:, 6:9], row[:, 9:12])
        near_is_L = jnp.where(hitL & hitR, tL <= tR, hitL)
        near = jnp.where(near_is_L, child[:, 0], child[:, 1])
        far = jnp.where(near_is_L, child[:, 1], child[:, 0])
        both = hitL & hitR
        any_child = hitL | hitR

        # leaf handling: decode -(start*8+count)-1
        is_leaf = active & (current < 0)
        leaf_val = -(current + 1)
        start = leaf_val // 8
        count = leaf_val % 8
        lbt, lbp, lbu, lbv = best_t, best_prim, best_u, best_v
        for k in range(LEAF_UNROLL):
            pidx = jnp.clip(start + k, 0, prim_verts.shape[0] - 1)
            pv = prim_verts[pidx]  # [N,4,3] gather
            h, u, v, t = intersect_quad(
                ro, rd, tmin, lbt, pv[:, 0], pv[:, 1], pv[:, 2], pv[:, 3]
            )
            h = h & is_leaf & (k < count)
            lbt = jnp.where(h, t, lbt)
            lbp = jnp.where(h, pidx.astype(jnp.int32), lbp)
            lbu = jnp.where(h, u, lbu)
            lbv = jnp.where(h, v, lbv)
        best_t, best_prim, best_u, best_v = lbt, lbp, lbu, lbv

        # internal node: descend near, push far
        do_push = active & is_internal & both & (sp < STACK_DEPTH)
        rows = jnp.arange(n)
        col = jnp.minimum(sp, STACK_DEPTH - 1)
        stack = stack.at[rows, col].set(
            jnp.where(do_push, far, stack[rows, col])
        )
        sp = jnp.where(do_push, sp + 1, sp)
        descend = active & is_internal & any_child
        next_current = jnp.where(descend, near, current)

        # pop for lanes that hit a leaf or a dead internal node
        need_pop = active & (is_leaf | (is_internal & ~any_child))
        if find_any:
            # stop as soon as any hit is recorded
            need_pop = need_pop & (best_prim < 0)
            active = active & ((best_prim < 0) | ~is_leaf)
        can_pop = need_pop & (sp > 0)
        sp_pop = jnp.maximum(sp - 1, 0)
        popped = stack[jnp.arange(n), sp_pop]
        next_current = jnp.where(can_pop, popped, next_current)
        sp = jnp.where(can_pop, sp_pop, sp)
        active = active & ~(need_pop & (sp == 0) & ~can_pop)

        return stack, sp, next_current, active, best_t, best_prim, best_u, best_v

    def cond(state):
        return jnp.any(state[3])

    state = (stack, sp, current, active, best_t, best_prim, best_u, best_v)
    state = jax.lax.while_loop(cond, step, state)
    _, _, _, _, best_t, best_prim, best_u, best_v = state
    hit = best_prim >= 0
    safe_prim = jnp.maximum(best_prim, 0)
    pos, gn = hit_surface(prim_verts, safe_prim, best_u, best_v)
    inst = (
        prim_instance[safe_prim] if prim_instance is not None
        else jnp.zeros_like(best_prim)
    )
    return Hit(
        hit, best_prim, best_u, best_v, jnp.where(hit, best_t, tmax), pos, gn, inst
    )

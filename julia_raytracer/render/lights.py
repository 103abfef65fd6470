"""Light table build (host) + device light sampling and pdf.

Semantics follow the reference light layer (src/trace.jl:102-187,
sample_lights src/trace.jl:968-1008, sample_lights_pdf
src/trace.jl:1010-1084) with two deliberate changes, both documented:

1. The env-texel -> direction mapping fixes the reference's 1-based
   off-by-one (`idx % width` with a 1-based idx, src/trace.jl:989-993);
   we use the correct 0-based texel coordinates. The pdf uses the same
   texel mapping, so the estimator stays consistent.

2. `sample_lights_pdf` for area lights is re-designed for a
   wavefront: the reference loops over every light and re-traces the
   direction against that light's private BVH for up to 100 successive
   hits (src/trace.jl:1029-1043) — a per-light serial loop whose key
   property is that each light's BVH contains ONLY that light's
   geometry, so occluders are invisible to the march. The wavefront
   equivalent is therefore NOT a march at all: intersect the ray
   against every emissive element directly (they are few — 2..336 in
   the corpus) and sum dist^2/(|cos| * area_owner) over all crossings
   (`area_lights_pdf_exact`). This is closed-form exhaustive — zero
   whole-scene traversals, zero truncation — and vectorizes as a
   lax.scan over small element slabs. A truncated whole-scene march
   remains only as a fallback for scenes with > EXACT_ELEMS emissive
   elements, where the O(lanes x elements) sweep would not pay.

CDF layout: all per-light element CDFs are raw float32 cumulative sums
(matching sample_discrete, src/sampling.jl:33-40) concatenated into one
flat array per light kind, with (offset, count) per light.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

import jax

from julia_raytracer.ops.geometry import (
    interpolate_quad, quad_normal, triangle_normal,
)
from julia_raytracer.scene.flatten import FLAG_IS_TRIANGLE_SHAPE, FlatScene
from julia_raytracer.utils.vecmath import (
    normalize, select_rows, transform_direction, transform_normal,
)

PIF = jnp.float32(np.pi)

# total light-element threshold for the gather-free (compare-select) path
# instead of per-lane gathers
DENSE_ELEMS = 64

# emissive-element cap for the exact (sweep-all-elements) light pdf; above
# this the O(lanes x elements) cost would rival a traversal and the
# truncated whole-scene march takes over. Corpus max is 336 (staircase2).
EXACT_ELEMS = 4096
# elements per scan slab in the exact pdf (bounds the [lanes, slab] temps)
ELEM_PDF_CHUNK = 16


class DeviceLights(NamedTuple):
    """Device-side light table (jnp arrays). Instance lights come first,
    then environment lights, matching the reference's ordering
    (src/trace.jl:121-186)."""

    # instance (area) lights
    inst_cdf: jnp.ndarray  # f32 [Ci] concatenated element-area cumsums
    inst_cdf_offset: jnp.ndarray  # i32 [Li]
    inst_cdf_count: jnp.ndarray  # i32 [Li]
    inst_prim: jnp.ndarray  # i32 [Ci] sorted-prim index per element
    inst_area: jnp.ndarray  # f32 [Li] total area (cdf last)
    # environment lights
    env_id: jnp.ndarray  # i32 [Le] environment index
    env_cdf: jnp.ndarray  # f32 [Ce] concatenated texel cumsums
    env_cdf_offset: jnp.ndarray  # i32 [Le]
    env_cdf_count: jnp.ndarray  # i32 [Le] (0 = no emission texture)
    # pdf march support: per sorted prim, owning light's total area (0 = not a light)
    prim_light_area: jnp.ndarray  # f32 [Q]
    # dense element tables (gather-free sampling when few light elements)
    elem_verts: jnp.ndarray  # f32 [Ci, 12] world corners of each light element
    elem_is_tri: jnp.ndarray  # bool [Ci]
    elem_owner_area: jnp.ndarray  # f32 [Ci] owning light's total area


@dataclass
class LightCounts:
    """Static light counts (compile-time constants for the integrator)."""

    n_instance: int
    n_env: int
    max_inst_elems: int = 1  # largest per-light element count (search depth)
    max_env_texels: int = 1
    total_inst_elems: int = 0  # sum over lights; small -> dense gather-free path

    @property
    def total(self) -> int:
        return self.n_instance + self.n_env


def build_lights(flat: FlatScene, order: np.ndarray) -> tuple[DeviceLights, LightCounts]:
    """Build the light table from the flattened scene (device arrays)."""
    np_lights, counts = build_lights_np(flat, order)
    return (
        DeviceLights(**{k: jnp.asarray(v) for k, v in np_lights.items()}),
        counts,
    )


def build_lights_np(flat: FlatScene, order: np.ndarray) -> tuple[dict, LightCounts]:
    """Build the light table from the flattened scene, as host numpy
    arrays (cacheable to disk without a device round-trip).

    `order` is the BVH primitive permutation; emitted prim indices refer
    to the *sorted* primitive arrays used by traversal.
    """
    g = flat.geometry
    m = flat.materials
    q = len(order)
    sorted_instance = g.prim_instance[order] if q else g.prim_instance
    sorted_verts = g.prim_verts[order] if q else g.prim_verts

    # per-sorted-prim area (quad_area handles degenerate quads = triangles)
    if q:
        p1, p2, p3, p4 = (sorted_verts[:, i] for i in range(4))
        a1 = 0.5 * np.linalg.norm(np.cross(p2 - p1, p4 - p1), axis=-1)
        a2 = 0.5 * np.linalg.norm(np.cross(p4 - p3, p2 - p3), axis=-1)
        prim_area = (a1 + a2).astype(np.float32)
    else:
        prim_area = np.zeros(0, np.float32)

    emissive_mat = (np.abs(m.emission).sum(axis=1) > 0) if len(m.emission) else np.zeros(0, bool)

    inst_cdf_parts, inst_prim_parts = [], []
    inst_offsets, inst_counts, inst_areas = [], [], []
    prim_light_area = np.zeros(max(q, 1), np.float32)
    offset = 0
    for i in range(flat.n_instances):
        mat = g.inst_material[i]
        if mat < 0 or not emissive_mat[mat]:
            continue
        prim_idx = np.nonzero(sorted_instance == i)[0]
        if len(prim_idx) == 0:
            continue  # shape without faces (src/trace.jl:127-129)
        areas = prim_area[prim_idx]
        cdf = np.cumsum(areas, dtype=np.float32)
        total = float(cdf[-1])
        inst_cdf_parts.append(cdf)
        inst_prim_parts.append(prim_idx.astype(np.int32))
        inst_offsets.append(offset)
        inst_counts.append(len(prim_idx))
        inst_areas.append(total)
        prim_light_area[prim_idx] = total
        offset += len(prim_idx)

    env_ids, env_offsets, env_counts, env_cdf_parts = [], [], [], []
    eoffset = 0
    env_emission = flat.environments.emission
    for e in range(len(env_emission)):
        if np.abs(env_emission[e]).sum() == 0:
            continue
        tex_id = int(flat.environments.emission_tex[e])
        if tex_id >= 0:
            w = int(flat.textures.width[tex_id])
            h = int(flat.textures.height[tex_id])
            toff = int(flat.textures.offset[tex_id])
            pix = flat.textures.data[toff : toff + w * h]  # raw values (lookup_texture default)
            j = np.arange(w * h) // w
            th = (j + 0.5).astype(np.float32) * np.float32(np.pi) / h
            # NB reference quirk preserved: maximum() spans all 4 channels
            # including alpha (src/trace.jl:177) — any positive weight is a
            # valid importance function as long as the pdf uses the same CDF
            weights = pix.max(axis=1) * np.sin(th)
            cdf = np.cumsum(weights, dtype=np.float32)
            env_cdf_parts.append(cdf)
            env_ids.append(e)
            env_offsets.append(eoffset)
            env_counts.append(w * h)
            eoffset += w * h
        else:
            env_ids.append(e)
            env_offsets.append(eoffset)
            env_counts.append(0)

    # dense per-element tables (sorted-prim data, element order == cdf order)
    all_prim_idx = (
        np.concatenate(inst_prim_parts) if inst_prim_parts else np.zeros(0, np.int64)
    ).astype(np.int64)
    total_elems = len(all_prim_idx)
    e_cap = max(total_elems, 1)
    elem_verts_np = np.zeros((e_cap, 12), np.float32)
    elem_is_tri_np = np.zeros(e_cap, bool)
    elem_owner_area_np = np.zeros(e_cap, np.float32)
    if total_elems:
        elem_verts_np[:total_elems] = sorted_verts[all_prim_idx].reshape(-1, 12)
        sorted_flags = g.prim_flags[order] if q else g.prim_flags
        elem_is_tri_np[:total_elems] = (
            sorted_flags[all_prim_idx] & FLAG_IS_TRIANGLE_SHAPE
        ) != 0
        elem_owner_area_np[:total_elems] = prim_light_area[all_prim_idx]

    lights = dict(
        inst_cdf=(
            np.concatenate(inst_cdf_parts) if inst_cdf_parts else np.zeros(1, np.float32)
        ),
        inst_cdf_offset=np.array(inst_offsets or [0], np.int32),
        inst_cdf_count=np.array(inst_counts or [0], np.int32),
        inst_prim=(
            np.concatenate(inst_prim_parts) if inst_prim_parts else np.zeros(1, np.int32)
        ),
        inst_area=np.array(inst_areas or [0], np.float32),
        env_id=np.array(env_ids or [0], np.int32),
        env_cdf=(
            np.concatenate(env_cdf_parts) if env_cdf_parts else np.zeros(1, np.float32)
        ),
        env_cdf_offset=np.array(env_offsets or [0], np.int32),
        env_cdf_count=np.array(env_counts or [0], np.int32),
        prim_light_area=prim_light_area,
        elem_verts=elem_verts_np,
        elem_is_tri=elem_is_tri_np,
        elem_owner_area=elem_owner_area_np,
    )
    counts = LightCounts(
        n_instance=len(inst_areas),
        n_env=len(env_ids),
        max_inst_elems=max(inst_counts) if inst_counts else 1,
        max_env_texels=max(env_counts) if env_counts else 1,
        total_inst_elems=total_elems,
    )
    return lights, counts


def auto_light_pdf_steps(n_lights: int, has_transmission: bool) -> int:
    """March budget for the FALLBACK truncated whole-scene march in
    sample_lights_pdf — only reached when a scene has > EXACT_ELEMS
    emissive elements (no corpus scene does; they all take the exact
    sweep, which ignores this knob). tests/test_light_pdf_fidelity.py
    showed truncated marches underestimate the pdf badly on occluded
    multi-light scenes (38% at 2 steps on staircase2), so the fallback
    budget is deliberately generous: occluder hits consume steps without
    accumulating (the reference's per-light BVHs never see occluders,
    src/trace.jl:1024-1043)."""
    if n_lights > 4 or has_transmission:
        return 8
    return 4


# ---------------------------------------------------------------------------
# Device-side sampling
# ---------------------------------------------------------------------------


def sample_discrete(cdf_flat, offset, count, r, max_count: int = 1 << 32):
    """Segmented sample_discrete (src/sampling.jl:33-40): pick index in
    [0, count) from the cumsum segment cdf_flat[offset : offset+count].

    Fixed-iteration binary search (upper_bound, src/sampling.jl:42-56)
    so it traces to a static loop; `max_count` (a static bound on
    any segment's length) sets the unrolled depth.
    """
    count = jnp.maximum(count, 1)
    total = cdf_flat[offset + count - 1]
    limit = jnp.clip(r * total, 0.0, total - 1e-5)
    lo = jnp.zeros_like(count)
    hi = count
    # search interval is [0, count] (count+1 states): bit_length(max_count)
    # = ceil(log2(max_count+1)) iterations. bit_length(max_count-1) is one
    # short when count is an exact power of two (e.g. 2048x1024 env CDFs),
    # silently folding element 1's mass into element 0.
    for _ in range(max(1, int(max_count).bit_length())):
        mid = (lo + hi) // 2
        go = lo < hi
        v = cdf_flat[jnp.clip(offset + mid, 0, cdf_flat.shape[0] - 1)]
        pred = v > limit
        hi = jnp.where(go & pred, mid, hi)
        lo = jnp.where(go & ~pred, mid + 1, lo)
    return jnp.clip(lo, 0, count - 1)


def sample_discrete_pdf(cdf_flat, offset, count, idx):
    """Weight of element idx = cdf[idx] - cdf[idx-1] (src/sampling.jl:38-39)."""
    hi = cdf_flat[jnp.clip(offset + idx, 0, cdf_flat.shape[0] - 1)]
    lo = jnp.where(
        idx > 0, cdf_flat[jnp.clip(offset + idx - 1, 0, cdf_flat.shape[0] - 1)], 0.0
    )
    return hi - lo


def sample_triangle_uv(ruv):
    """Uniform triangle warp (src/sampling.jl:60)."""
    s = jnp.sqrt(ruv[..., 0])
    return jnp.stack([1.0 - s, ruv[..., 1] * s], axis=-1)


def sample_sphere(ruv):
    """Uniform sphere direction."""
    z = 2.0 * ruv[..., 1] - 1.0
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    phi = 2.0 * PIF * ruv[..., 0]
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def _env_texel_direction(scene, env_idx, texel, tex_id):
    """Texel index -> world direction through the env frame
    (src/trace.jl:985-1001, with the 0-based texel fix)."""
    w = scene.textures.width[tex_id]
    h = scene.textures.height[tex_id]
    u = ((texel % jnp.maximum(w, 1)).astype(jnp.float32) + 0.5) / w.astype(jnp.float32)
    v = ((texel // jnp.maximum(w, 1)).astype(jnp.float32) + 0.5) / h.astype(jnp.float32)
    local = jnp.stack(
        [
            jnp.cos(u * 2.0 * PIF) * jnp.sin(v * PIF),
            jnp.cos(v * PIF),
            jnp.sin(u * 2.0 * PIF) * jnp.sin(v * PIF),
        ],
        axis=-1,
    )
    frame = scene.env_frame[env_idx]
    return transform_direction(frame, local)


def sample_lights(scene, lights: DeviceLights, counts: LightCounts, position, rl, rel, ruv):
    """Pick a light uniformly, then a point/texel by CDF; return the world
    direction from `position` (src/trace.jl:968-1008). Batched over lanes."""
    L = counts.total
    if L == 0:
        return jnp.zeros_like(position)
    lid = jnp.clip((rl * L).astype(jnp.int32), 0, L - 1)

    direction = jnp.zeros_like(position)

    if counts.n_instance > 0:
        li = jnp.clip(lid, 0, counts.n_instance - 1)
        dense = 0 < counts.total_inst_elems <= DENSE_ELEMS and counts.n_instance <= DENSE_ELEMS
        if dense:
            # gather-free: light metadata + element pick + element verts all
            # resolved with compare-select chains over tiny static tables
            off = select_rows(lights.inst_cdf_offset, li, counts.n_instance)
            cnt = select_rows(lights.inst_cdf_count, li, counts.n_instance)
            total = select_rows(lights.inst_area, li, counts.n_instance)
            limit = jnp.clip(rel * total, 0.0, total - 1e-5)
            idx = jnp.zeros_like(off)
            for e in range(counts.total_inst_elems):
                in_seg = (e >= off) & (e < off + cnt)
                idx = idx + (in_seg & (lights.inst_cdf[e] <= limit)).astype(jnp.int32)
            eg = off + jnp.clip(idx, 0, cnt - 1)
            v12 = select_rows(lights.elem_verts, eg, counts.total_inst_elems)
            verts = v12.reshape(v12.shape[:-1] + (4, 3))
            is_tri = (
                select_rows(
                    lights.elem_is_tri.astype(jnp.float32), eg, counts.total_inst_elems
                )
                > 0.5
            )
        else:
            off = lights.inst_cdf_offset[li]
            cnt = lights.inst_cdf_count[li]
            elem = sample_discrete(
                lights.inst_cdf, off, cnt, rel, max_count=counts.max_inst_elems
            )
            # element tables, not scene prims: identical data
            # (elem_verts[e] == sorted_verts[inst_prim[e]]), contiguous
            # per light
            eg = jnp.clip(off + elem, 0, lights.elem_verts.shape[0] - 1)
            v12 = lights.elem_verts[eg]
            verts = v12.reshape(v12.shape[:-1] + (4, 3))
            is_tri = lights.elem_is_tri[eg]
        uv = jnp.where(is_tri[..., None], sample_triangle_uv(ruv), ruv)
        lpos = interpolate_quad(
            verts[..., 0, :], verts[..., 1, :], verts[..., 2, :], verts[..., 3, :],
            uv[..., 0], uv[..., 1],
        )
        inst_dir = normalize(lpos - position)
        direction = jnp.where((lid < counts.n_instance)[..., None], inst_dir, direction)

    if counts.n_env > 0:
        ei = jnp.clip(lid - counts.n_instance, 0, counts.n_env - 1)
        if scene.textures.width.shape[0] == 0:
            # untextured environments: uniform sphere only (no texel CDF)
            env_dir = sample_sphere(ruv)
        else:
            env_idx = lights.env_id[ei]
            cnt = lights.env_cdf_count[ei]
            off = lights.env_cdf_offset[ei]
            texel = sample_discrete(
                lights.env_cdf, off, jnp.maximum(cnt, 1), rel,
                max_count=counts.max_env_texels,
            )
            tex_id = jnp.maximum(scene.env_emission_tex[env_idx], 0)
            tex_dir = _env_texel_direction(scene, env_idx, texel, tex_id)
            env_dir = jnp.where((cnt > 0)[..., None], tex_dir, sample_sphere(ruv))
        direction = jnp.where((lid >= counts.n_instance)[..., None], env_dir, direction)

    return direction


def env_lights_pdf(scene, lights: DeviceLights, counts: LightCounts, direction):
    """Sum of env-light direction pdfs (src/trace.jl:1046-1078), without
    the final 1/L factor."""
    pdf = jnp.zeros(direction.shape[:-1], jnp.float32)
    if scene.textures.width.shape[0] == 0:
        # untextured environments sample the uniform sphere
        return pdf + counts.n_env / (4.0 * PIF)
    for ei in range(counts.n_env):
        env_idx = lights.env_id[ei]
        cnt = lights.env_cdf_count[ei]
        off = lights.env_cdf_offset[ei]
        tex_id = jnp.maximum(scene.env_emission_tex[env_idx], 0)
        w = scene.textures.width[tex_id]
        h = scene.textures.height[tex_id]
        wl = transform_normal(scene.env_frame_inv[env_idx], direction)
        tx = jnp.arctan2(wl[..., 2], wl[..., 0]) / (2.0 * PIF)
        tx = jnp.where(tx < 0.0, tx + 1.0, tx)
        ty = jnp.arccos(jnp.clip(wl[..., 1], -1.0, 1.0)) / PIF
        i = jnp.clip((tx * w).astype(jnp.int32), 0, w - 1)
        j = jnp.clip((ty * h).astype(jnp.int32), 0, h - 1)
        idx = j * w + i
        seg_total = lights.env_cdf[jnp.clip(off + cnt - 1, 0, lights.env_cdf.shape[0] - 1)]
        prob = sample_discrete_pdf(lights.env_cdf, off, cnt, idx) / jnp.maximum(seg_total, 1e-30)
        angle = (
            (2.0 * PIF / w.astype(jnp.float32))
            * (PIF / h.astype(jnp.float32))
            * jnp.sin(PIF * (j.astype(jnp.float32) + 0.5) / h.astype(jnp.float32))
        )
        with_tex = prob / jnp.maximum(angle, 1e-30)
        no_tex = jnp.full_like(with_tex, 1.0 / (4.0 * PIF))
        pdf = pdf + jnp.where(cnt > 0, with_tex, no_tex)
    return pdf


def area_light_hit_pdf(
    lights: DeviceLights, prim, dist2, lnormal, direction, hit, total_elems: int = 0
):
    """One march-step contribution: dist^2 / (|cos| * area_owner) when the
    hit prim belongs to a light (src/trace.jl:1036-1041). With few light
    elements the owner lookup is a compare-select over the element prim
    ids instead of a gather from the per-prim area array."""
    if 0 < total_elems <= DENSE_ELEMS:
        area = jnp.zeros(prim.shape, jnp.float32)
        for e in range(total_elems):
            area = jnp.where(
                prim == lights.inst_prim[e], lights.elem_owner_area[e], area
            )
    else:
        area = lights.prim_light_area[
            jnp.clip(prim, 0, lights.prim_light_area.shape[0] - 1)
        ]
    cos = jnp.abs(jnp.sum(lnormal * direction, axis=-1))
    contrib = dist2 / jnp.maximum(cos * area, 1e-30)
    return jnp.where(hit & (area > 0), contrib, 0.0)


def area_lights_pdf_exact(lights: DeviceLights, counts: LightCounts, position, direction):
    """Exact area-light pdf: sum t^2/(|cos|*area_owner) over EVERY
    emissive element the ray crosses — the closed-form equivalent of the
    reference's occluder-ignoring per-light BVH marches
    (src/trace.jl:1024-1043, up to 100 hits per light). Elements are
    swept as two triangles each, (p1,p2,p4)+(p3,p4,p2) with the quirk
    that our embedded triangles have p3==p4 so the second never hits
    (src/geometry.jl:238-258), in ELEM_PDF_CHUNK-wide slabs under
    lax.scan to bound the [lanes, slab] temporaries."""
    ci = counts.total_inst_elems
    lanes = position.shape[:-1]
    if ci == 0:
        return jnp.zeros(lanes, jnp.float32)
    chunk = min(ELEM_PDF_CHUNK, ci)
    n_slabs = -(-ci // chunk)
    pad = n_slabs * chunk - ci
    verts = lights.elem_verts[:ci]
    areas = lights.elem_owner_area[:ci]
    if pad:
        verts = jnp.concatenate([verts, jnp.zeros((pad, 12), jnp.float32)], axis=0)
        areas = jnp.concatenate([areas, jnp.zeros((pad,), jnp.float32)], axis=0)
    verts = verts.reshape(n_slabs, chunk, 4, 3)
    areas = areas.reshape(n_slabs, chunk)
    ro = position[..., None, :]
    rd = direction[..., None, :]
    tmin = jnp.float32(1e-4)

    def lex_less(p, q):
        """Strict lexicographic order of 3D points — the edge-ownership
        tie-break below."""
        return jnp.where(
            p[..., 0] != q[..., 0],
            p[..., 0] < q[..., 0],
            jnp.where(p[..., 1] != q[..., 1], p[..., 1] < q[..., 1], p[..., 2] < q[..., 2]),
        )

    def tri_contrib(a, b, c, area):
        """Moller-Trumbore with HALF-OPEN boundaries: a hit exactly on a
        shared edge must count once, not once per adjacent triangle (the
        reference's march steps 1e-3 past each hit, src/trace.jl:1042, so
        coplanar duplicates are skipped). Each directed winding edge
        (a->b, b->c, c->a) owns its boundary iff its endpoints ascend
        lexicographically; adjacent triangles traverse a shared edge in
        opposite directions, so exactly one claims it."""
        edge1 = b - a
        edge2 = c - a
        pvec = jnp.cross(rd, edge2[None])
        det = jnp.sum(edge1[None] * pvec, axis=-1)
        inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
        tvec = ro - a[None]
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, edge1[None])
        v = jnp.sum(rd * qvec, axis=-1) * inv_det
        t = jnp.sum(edge2[None] * qvec, axis=-1) * inv_det
        own_ab = lex_less(a, b)[None]  # v == 0 lies on edge a-b
        own_bc = lex_less(b, c)[None]  # u + v == 1 lies on edge b-c
        own_ca = lex_less(c, a)[None]  # u == 0 lies on edge c-a
        hit = (
            (det != 0.0)
            & ((v > 0.0) | ((v == 0.0) & own_ab))
            & ((u > 0.0) | ((u == 0.0) & own_ca))
            & ((u + v < 1.0) | ((u + v == 1.0) & own_bc))
            & (t >= tmin)
        )
        nrm = triangle_normal(a, b, c)  # [chunk, 3]
        cos = jnp.abs(jnp.sum(nrm[None] * rd, axis=-1))
        contrib = t * t / jnp.maximum(cos * area[None], 1e-30)
        return jnp.where(hit & (area[None] > 0), contrib, 0.0).sum(axis=-1)

    def slab(pdf, xs):
        v, a = xs
        p1, p2, p3, p4 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
        # quad = (p1,p2,p4)+(p3,p4,p2) (src/geometry.jl:238-258); embedded
        # triangles have p3 == p4 so the second is degenerate (det == 0)
        pdf = pdf + tri_contrib(p1, p2, p4, a) + tri_contrib(p3, p4, p2, a)
        return pdf, None

    pdf, _ = jax.lax.scan(slab, jnp.zeros(lanes, jnp.float32), (verts, areas))
    return pdf


def sample_lights_pdf(
    scene,
    lights: DeviceLights,
    counts: LightCounts,
    intersect_fn,
    position,
    direction,
    first_hit,  # (hit, prim, u, v, t) from the already-computed next intersection
    extra_steps: int = 4,
):
    """Solid-angle pdf of `direction` under light sampling
    (src/trace.jl:1010-1084); see module docstring. Area lights take the
    exact element sweep when the scene has <= EXACT_ELEMS emissive
    elements (all corpus scenes; `intersect_fn`/`first_hit`/`extra_steps`
    are unused there). Bigger emissive sets fall back to the truncated
    whole-scene march: `first_hit` reuses the bounce's own intersection
    as step 1 and `extra_steps` adds whole-scene traversals."""
    L = counts.total
    if L == 0:
        return jnp.zeros(position.shape[:-1], jnp.float32)

    pdf = jnp.zeros(position.shape[:-1], jnp.float32)

    if 0 < counts.total_inst_elems <= EXACT_ELEMS:
        pdf = pdf + area_lights_pdf_exact(lights, counts, position, direction)
    elif counts.n_instance > 0:
        hit, prim, t, lnormal = (
            first_hit.hit, first_hit.prim, first_hit.t, first_hit.gnormal,
        )
        t_cum = t
        pdf = pdf + area_light_hit_pdf(
            lights, prim, t_cum * t_cum, lnormal, direction, hit,
            total_elems=counts.total_inst_elems,
        )
        marching = hit
        for _ in range(extra_steps):
            # continue from just past the last hit (0.001 offset, src/trace.jl:1042)
            origin = position + direction * (t_cum + 1e-3)[..., None]
            tmin = jnp.full_like(t_cum, 1e-4)
            # non-marching lanes carry tmax = -1: a tiny POSITIVE tmax
            # still passes slab tests when the origin sits inside a bbox
            # (see render/integrator.py dead-lane note)
            tmax = jnp.where(marching, jnp.float32(3.4028235e38), jnp.float32(-1.0))
            step = intersect_fn(origin, direction, tmin, tmax)
            hit = step.hit & marching
            t_cum = jnp.where(hit, t_cum + 1e-3 + step.t, t_cum)
            pdf = pdf + area_light_hit_pdf(
                lights, step.prim, t_cum * t_cum, step.gnormal, direction, hit,
                total_elems=counts.total_inst_elems,
            )
            marching = hit

    if counts.n_env > 0:
        pdf = pdf + env_lights_pdf(scene, lights, counts, direction)

    return pdf * jnp.float32(1.0 / L)

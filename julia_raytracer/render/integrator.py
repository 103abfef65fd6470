"""Wavefront path integrators (naive + MIS path tracing with volumes).

Wavefront inversion of the reference's per-ray recursion
(src/trace.jl:276-573): the whole ray batch advances in lock-step inside
one `lax.while_loop`; every lane carries its own bounce counter, weight,
RNG stream, and a one-slot volume stack (the reference's volume stack
never exceeds depth 1: it pushes only when empty, src/trace.jl:405-421).

The loop carries the *current intersection* across iterations: each body
computes the NEXT ray's intersection at its end. That single traversal
serves double duty — it is both the next bounce's hit and march step 1
of the MIS light pdf (see render/lights.py), so the reference's
pdf re-tracing loop (src/trace.jl:1029-1043) costs zero extra traversals
in the default configuration.

Control-flow parity with src/trace.jl:
  - miss -> env radiance unless (bounce == 0 and envhidden)   :299-304
  - volume transmittance sampling before surface work          :306-326
  - stochastic opacity skip, cap 128, bounce not consumed      :356-364
  - first-hit AOVs (albedo/normal) at bounce 0                 :366-370
  - one-sample MIS, 50/50 bsdf/light, balance-heuristic weight :375-397
  - delta materials bypass MIS                                 :398-403
  - volume push/pop on transmission through volumetric         :405-421
  - in-volume scattering with the same 50/50 MIS               :424-453
  - weight zero/non-finite break                               :455-457
  - Russian roulette after bounce 3, p = min(.99, max(w))      :459-465
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from julia_raytracer.ops import bsdf as bsdf_ops
from julia_raytracer.ops import eval as eval_ops
from julia_raytracer.ops.geometry import F32_MAX, RAY_EPS
from julia_raytracer.ops.traversal import Hit, intersect_bvh
from julia_raytracer.ops.triton_intersect import intersect_dense
from julia_raytracer.render import dispatch, lights as lights_mod
from julia_raytracer.render.scene_device import DeviceScene, SceneConfig
from julia_raytracer.utils import rng as rng_mod
from julia_raytracer.utils.vecmath import dot

# scenes of at most this many prims take the dense all-prims test
# (ops/triton_intersect.py) instead of the BVH walk. On an H100 the dense
# kernel beat the lockstep BVH up to 30k prims for camera rays and past
# it for random rays (PERF.md, dense test vs BVH by prim count)
BRUTEFORCE_THRESHOLD = 16384

# survivor compaction (trace_wavefront): a wavefront narrower than
# COMPACT_MIN_LANES runs one while_loop. Otherwise each level drains
# until the survivors fit width / div (never below COMPACT_MIN_CAP
# lanes), narrows the state, and the next level repeats. Sorted
# wavefronts narrow by slicing; unsorted ones gather the survivors
# through an argsort and scatter the outputs back.
COMPACT_MIN_LANES = 16384
COMPACT_MIN_CAP = 4096
COMPACT_DIV = {"slice": 2, "gather": 4}
COMPACT_LEVELS = {"slice": 5, "gather": 2}


class TraceOptions(NamedTuple):
    """Static integrator options (mirrors the Params subset that affects
    tracing, src/cli.jl:13-86)."""

    sampler: str = "path"  # "path" | "naive"
    bounces: int = 8
    envhidden: bool = False
    nocaustics: bool = False
    light_pdf_extra_steps: int = 2  # extra whole-scene marches for the light pdf
    # 0 = data-dependent lax.while_loop (fastest). A positive value runs a
    # fixed-trip lax.scan instead — required for reverse-mode autodiff
    # (while_loop has no transpose rule); set to bounces + 1 + an opacity
    # retry budget. The loop body is fully masked, so both modes produce
    # identical results.
    fixed_iterations: int = 0
    # sort the wavefront between bounces by (liveness, octant,
    # morton(origin)): dead lanes gather at the tail and live lanes
    # become spatially coherent (SURVEY §7 step 6) — a permutation, no
    # dynamic shapes.
    sort_rays: bool = False
    # survivor compaction: sorted wavefronts narrow by slicing, unsorted
    # ones by gathering (faster than the plain loop at the flagship shape,
    # PERF.md). False runs every lane in one while_loop, the oracle the
    # compaction tests compare with. Results are identical.
    compact: bool = True


def curve_wrap(intersect, dscene: DeviceScene, config: SceneConfig):
    """Merge line/point (capsule) primitives into a quad intersector's
    closest hit (src/geometry.jl:113-172, src/bvh.jl:408-443). Curve hits
    are encoded as prim ids >= Q (Q..Q+L-1 lines, then points); their
    `position` is the element point — interpolate_line(p1,p2,u) / the
    point center — matching eval_position (src/scene.jl:465-475), and
    `gnormal` carries the interpolated tangent (lines) / outgoing
    (points) for the shading-normal rules (src/scene.jl:511-518)."""
    from julia_raytracer.ops.geometry import intersect_line, intersect_point
    from julia_raytracer.utils.vecmath import normalize

    L, P = config.n_lines, config.n_points
    if L == 0 and P == 0:
        return intersect
    Q = dscene.prim_verts.shape[0]

    def wrapped(ro, rd, tmin, tmax):
        if Q > 0:
            h = intersect(ro, rd, tmin, tmax)
        else:
            n = ro.shape[0]
            z = jnp.zeros(n, jnp.float32)
            h = Hit(jnp.zeros(n, bool), jnp.full(n, -1, jnp.int32), z, z,
                    tmax, jnp.zeros((n, 3), jnp.float32),
                    jnp.zeros((n, 3), jnp.float32), jnp.zeros(n, jnp.int32))
        best = h
        bt = jnp.where(best.hit, best.t, tmax)
        if L > 0:
            p1 = dscene.line_verts[None, :, 0]  # [1, L, 3]
            p2 = dscene.line_verts[None, :, 1]
            r1 = dscene.line_radius[None, :, 0]
            r2 = dscene.line_radius[None, :, 1]
            lh, ls, lv, lt = intersect_line(
                ro[:, None], rd[:, None], tmin[:, None], bt[:, None],
                p1, p2, r1, r2,
            )  # each [n, L]
            lt = jnp.where(lh, lt, F32_MAX)
            li = jnp.argmin(lt, axis=1)
            ltb = jnp.take_along_axis(lt, li[:, None], axis=1)[:, 0]
            upd = ltb < bt
            take = lambda a: jnp.take_along_axis(a, li[:, None], axis=1)[:, 0]
            s_ = take(ls)
            v_ = take(lv)
            lp1 = dscene.line_verts[li, 0]
            lp2 = dscene.line_verts[li, 1]
            axis_pt = lp1 + (lp2 - lp1) * s_[:, None]
            tan = normalize(
                dscene.line_attr[li, 0, 0:3] * (1.0 - s_[:, None])
                + dscene.line_attr[li, 1, 0:3] * s_[:, None]
            )
            best = Hit(
                hit=best.hit | upd,
                prim=jnp.where(upd, Q + li.astype(jnp.int32), best.prim),
                u=jnp.where(upd, s_, best.u),
                v=jnp.where(upd, v_, best.v),
                t=jnp.where(upd, ltb, best.t),
                position=jnp.where(upd[:, None], axis_pt, best.position),
                gnormal=jnp.where(upd[:, None], tan, best.gnormal),
                instance=jnp.where(upd, dscene.line_instance[li], best.instance),
            )
            bt = jnp.where(best.hit, best.t, tmax)
        if P > 0:
            ph, pt = intersect_point(
                ro[:, None], rd[:, None], tmin[:, None], bt[:, None],
                dscene.point_pos[None], dscene.point_radius[None],
            )
            pt = jnp.where(ph, pt, F32_MAX)
            pi = jnp.argmin(pt, axis=1)
            ptb = jnp.take_along_axis(pt, pi[:, None], axis=1)[:, 0]
            upd = ptb < bt
            best = Hit(
                hit=best.hit | upd,
                prim=jnp.where(upd, Q + L + pi.astype(jnp.int32), best.prim),
                u=jnp.where(upd, 0.0, best.u),
                v=jnp.where(upd, 0.0, best.v),
                t=jnp.where(upd, ptb, best.t),
                position=jnp.where(upd[:, None], dscene.point_pos[pi], best.position),
                gnormal=jnp.where(upd[:, None], -normalize(rd), best.gnormal),
                instance=jnp.where(upd, dscene.point_instance[pi], best.instance),
            )
        return best

    return wrapped


def intersector_name(config: SceneConfig) -> str:
    """Which closest-hit query make_intersect builds for this scene."""
    if config.root_is_leaf or config.n_prims <= BRUTEFORCE_THRESHOLD:
        return "dense"
    return "bvh"


def make_intersect(dscene: DeviceScene, config: SceneConfig):
    """Closest-hit query against the device scene (traceable; reads the
    possibly-traced dscene arrays). Scenes of at most
    BRUTEFORCE_THRESHOLD prims take the dense all-prims test (the Triton
    kernel on the GPU); larger ones the lockstep BVH walk."""
    if intersector_name(config) == "dense":
        def intersect(ro, rd, tmin, tmax):
            return intersect_dense(
                dscene.prim_verts, ro, rd, tmin, tmax,
                prim_instance=dscene.prim_instance,
            )
    else:
        def intersect(ro, rd, tmin, tmax):
            return intersect_bvh(
                dscene.nodes, dscene.prim_verts, ro, rd, tmin, tmax,
                prim_instance=dscene.prim_instance,
            )
    return curve_wrap(intersect, dscene, config)


def _vec(mask):
    return mask[..., None]


def _spread3(x):
    """Spread 10 bits to every 3rd bit (morton interleave helper)."""
    x = (x | (x << 16)) & 0x30000FF
    x = (x | (x << 8)) & 0x300F00F
    x = (x | (x << 4)) & 0x30C30C3
    x = (x | (x << 2)) & 0x9249249
    return x


def _morton3(pos, vmin, vmax):
    """[N,3] world position -> 30-bit morton key (10 bits/axis)."""
    scale = 1023.0 / jnp.maximum(vmax - vmin, 1e-30)
    q = jnp.clip(((pos - vmin) * scale), 0.0, 1023.0).astype(jnp.int32)
    return (
        _spread3(q[..., 0])
        | (_spread3(q[..., 1]) << 1)
        | (_spread3(q[..., 2]) << 2)
    )


def _sort_key(ro, rd, vmin, vmax):
    """Wavefront coherence key: octant(3) | origin-morton(18) |
    direction-morton(9), 30 bits total.

    The octant groups rays whose slab tests share sign structure; the
    origin bits (6/axis — neighbourhood locality only needs the top
    few) keep neighbouring lanes' footprints compact; the DIRECTION bits
    refine within an (octant, origin-cell): without them pinhole-camera
    primaries (all origins equal) sort to scanline strips spanning the
    whole image width. With them, equal-origin rays tile by direction
    == image tiles."""
    octant = (
        ((rd[:, 0] < 0).astype(jnp.int32) << 2)
        | ((rd[:, 1] < 0).astype(jnp.int32) << 1)
        | (rd[:, 2] < 0).astype(jnp.int32)
    )
    om = _morton3(ro, vmin, vmax) >> 12  # top 18 bits
    ad = jnp.abs(rd)
    qd = jnp.clip(ad * 7.999, 0.0, 7.0).astype(jnp.int32)
    dm = (
        _spread3(qd[:, 0])
        | (_spread3(qd[:, 1]) << 1)
        | (_spread3(qd[:, 2]) << 2)
    )  # 9 bits (3/axis)
    return (octant << 27) | (om << 9) | dm


def trace_wavefront(
    dscene: DeviceScene,
    config: SceneConfig,
    options: TraceOptions,
    ro,
    rd,
    rng_state,
    intersect=None,
    alive_trace: bool = False,
):
    """Trace a batch of rays to completion.

    Returns (radiance [N,3], hit [N] bool, albedo [N,3], normal [N,3],
    rng_state) matching trace_path/trace_naive's return contract
    (src/trace.jl:468, :571). `intersect` defaults to make_intersect over
    the (possibly traced) `dscene`."""
    n = ro.shape[0]
    if intersect is None:
        intersect = make_intersect(dscene, config)

    is_path = options.sampler == "path"
    counts = config.light_counts
    has_lights = counts.total > 0

    zeros3 = jnp.zeros((n, 3), jnp.float32)

    class S(NamedTuple):
        ro: jnp.ndarray
        rd: jnp.ndarray
        isec_hit: jnp.ndarray
        isec_prim: jnp.ndarray
        isec_u: jnp.ndarray
        isec_v: jnp.ndarray
        isec_t: jnp.ndarray
        isec_pos: jnp.ndarray
        isec_gn: jnp.ndarray
        isec_inst: jnp.ndarray
        radiance: jnp.ndarray
        weight: jnp.ndarray
        rng: jnp.ndarray
        bounce: jnp.ndarray
        opbounce: jnp.ndarray
        alive: jnp.ndarray
        hit_flag: jnp.ndarray
        hit_albedo: jnp.ndarray
        hit_normal: jnp.ndarray
        max_roughness: jnp.ndarray
        vol_density: jnp.ndarray
        vol_scattering: jnp.ndarray
        vol_aniso: jnp.ndarray
        has_vol: jnp.ndarray
        idx: jnp.ndarray  # original lane id (identity unless sort_rays)

    do_sort = options.sort_rays and options.fixed_iterations == 0
    if do_sort:
        pv_flat = dscene.prim_verts.reshape(-1, 3)
        scene_vmin = jnp.min(pv_flat, axis=0)
        scene_vmax = jnp.max(pv_flat, axis=0)

    idx0 = jnp.arange(n, dtype=jnp.int32)
    if do_sort:
        # sort PRIMARY rays too: camera rays arrive in scanline order,
        # so 1024-lane blocks span whole scanlines (full-scene frusta);
        # the direction bits in the key turn equal-origin pinhole blocks
        # into image tiles (see _sort_key)
        perm0 = jnp.argsort(_sort_key(ro, rd, scene_vmin, scene_vmax))
        ro, rd, rng_state, idx0 = jax.tree_util.tree_map(
            lambda a: a[perm0], (ro, rd, rng_state, idx0)
        )

    h0 = intersect(ro, rd, jnp.full(n, RAY_EPS), jnp.full(n, F32_MAX))
    state = S(
        ro=ro,
        rd=rd,
        isec_hit=h0.hit,
        isec_prim=h0.prim,
        isec_u=h0.u,
        isec_v=h0.v,
        isec_t=h0.t,
        isec_pos=h0.position,
        isec_gn=h0.gnormal,
        isec_inst=h0.instance,
        radiance=zeros3,
        weight=jnp.ones((n, 3), jnp.float32),
        rng=rng_state,
        bounce=jnp.full(n, -1, jnp.int32),
        opbounce=jnp.zeros(n, jnp.int32),
        alive=jnp.ones(n, bool),
        hit_flag=jnp.zeros(n, bool),
        hit_albedo=zeros3,
        hit_normal=zeros3,
        max_roughness=jnp.zeros(n, jnp.float32),
        vol_density=zeros3,
        vol_scattering=zeros3,
        vol_aniso=jnp.zeros(n, jnp.float32),
        has_vol=jnp.zeros(n, bool),
        idx=idx0,
    )

    def body(s: S) -> S:
        # width-polymorphic: the two-phase compaction (below) re-enters
        # this body with a narrowed survivor buffer, so every lane-shaped
        # constant derives from the state, not the closure n
        n = s.alive.shape[0]
        alive = s.alive
        bounce = jnp.where(alive, s.bounce + 1, s.bounce)
        rng = s.rng
        radiance, weight = s.radiance, s.weight
        outgoing = -s.rd

        # ---- miss: environment lookup (src/trace.jl:299-304)
        miss = alive & ~s.isec_hit
        if config.n_envs > 0:
            env_ok = (bounce > 0) if options.envhidden else jnp.ones(n, bool)
            env = eval_ops.eval_environment(dscene, s.rd)
            radiance = radiance + jnp.where(_vec(miss & env_ok), weight * env, 0.0)
        alive = alive & s.isec_hit

        # ---- volume transmittance (src/trace.jl:306-326)
        if is_path and config.has_volumes:
            in_med = alive & s.has_vol
            rl, rng = rng_mod.rand1f(rng)
            rdist, rng = rng_mod.rand1f(rng)
            dist = bsdf_ops.sample_transmittance(s.vol_density, s.isec_t, rl, rdist)
            trans = bsdf_ops.eval_transmittance(s.vol_density, dist)
            tpdf = jax.lax.stop_gradient(
                bsdf_ops.sample_transmittance_pdf(s.vol_density, dist, s.isec_t)
            )
            weight = jnp.where(
                _vec(in_med), weight * trans / jnp.maximum(tpdf, 1e-30)[..., None], weight
            )
            in_volume = in_med & (dist < s.isec_t)
        else:
            in_volume = jnp.zeros(n, bool)
            dist = s.isec_t

        surf = alive & ~in_volume

        # ---- surface evaluation (src/scene.jl:416-673). Position and the
        # element normal come from the intersector; vertex/flag gathers only
        # happen when the scene actually carries those attributes.
        prim = jnp.clip(s.isec_prim, 0, dscene.prim_verts.shape[0] - 1)
        u, v = s.isec_u, s.isec_v
        position = s.isec_pos
        inst = s.isec_inst
        need_attrs = (
            config.has_texcoords or config.has_colors
            or config.has_vertex_normals or config.has_normal_maps
        )
        if need_attrs:
            vidx = dscene.prim_vidx[prim]
            flags = dscene.prim_flags[prim]
        else:
            vidx = flags = None
        verts = dscene.prim_verts[prim] if config.has_normal_maps else None
        if config.has_texcoords:
            texcoord = eval_ops.eval_texcoord(dscene, vidx, flags, u, v)
        else:
            texcoord = jnp.stack([u, v], axis=-1)
        if config.has_colors:
            shp_color = eval_ops.eval_color_attr(dscene, vidx, flags, u, v)
        else:
            shp_color = jnp.ones(u.shape + (4,), jnp.float32)
        # ---- curve/point attribute overrides (prim ids >= Q encode
        # lines then points; see curve_wrap)
        has_curves = config.n_lines > 0 or config.n_points > 0
        if has_curves:
            Q = dscene.prim_verts.shape[0]
            is_line = s.isec_hit & (s.isec_prim >= Q) & (
                s.isec_prim < Q + config.n_lines
            )
            is_point = s.isec_hit & (s.isec_prim >= Q + config.n_lines)
            if config.n_lines > 0:
                li = jnp.clip(s.isec_prim - Q, 0, config.n_lines - 1)
                lat = dscene.line_attr[li]  # [n, 2, 9]
                wu = u[:, None]
                l_tc = lat[:, 0, 3:5] * (1.0 - wu) + lat[:, 1, 3:5] * wu
                l_col = lat[:, 0, 5:9] * (1.0 - wu) + lat[:, 1, 5:9] * wu
                texcoord = jnp.where(_vec(is_line), l_tc, texcoord)
                shp_color = jnp.where(_vec(is_line), l_col, shp_color)
            if config.n_points > 0:
                pi = jnp.clip(
                    s.isec_prim - Q - config.n_lines, 0, config.n_points - 1
                )
                pat = dscene.point_attr[pi]  # [n, 9]
                texcoord = jnp.where(_vec(is_point), pat[:, 3:5], texcoord)
                shp_color = jnp.where(_vec(is_point), pat[:, 5:9], shp_color)
        # gather-free material eval for small scenes (select-chain over the
        # folded per-instance table); disabled in differentiable
        # (fixed-trip) mode where grads flow through dscene.materials,
        # which the dense table shadows
        dense_mats = 0 < config.n_instances <= 64 and options.fixed_iterations == 0
        if dense_mats and not config.has_textures:
            material = eval_ops.eval_material_dense(
                dscene, inst, shp_color, config.n_instances
            )
            normal_tex = jnp.full(n, -1, jnp.int32)  # no textures by construction
        elif dense_mats:
            from julia_raytracer.utils.vecmath import select_rows

            rows = select_rows(dscene.inst_mat_dense, inst, config.n_instances)
            material = eval_ops.eval_material_rows(dscene, rows, texcoord, shp_color)
            normal_tex = rows[..., 20].astype(jnp.int32)
        else:
            material = eval_ops.eval_material(dscene, inst, texcoord, shp_color)
            mid = dscene.inst_material[inst]
            normal_tex = dscene.materials.normal_tex[mid]
        normal = eval_ops.eval_shading_normal(
            dscene, s.isec_gn, verts, vidx, inst, flags, u, v, outgoing,
            material.type, normal_tex, texcoord,
            with_normalmap=config.has_normal_maps,
            with_vertex_normals=config.has_vertex_normals,
            refractive_present=int(4) in config.present_types,
        )
        if has_curves:
            # lines: frame the tangent against the view
            # (orthonormalize(outgoing, tangent), src/scene.jl:511-515);
            # points: normal IS the outgoing direction (:516-518)
            from julia_raytracer.utils.vecmath import orthonormalize

            if config.n_lines > 0:
                normal = jnp.where(
                    _vec(is_line), orthonormalize(outgoing, s.isec_gn), normal
                )
            if config.n_points > 0:
                normal = jnp.where(_vec(is_point), outgoing, normal)

        max_roughness = s.max_roughness
        if is_path and options.nocaustics:
            # clamp roughness to the running max (src/trace.jl:349-354)
            max_roughness = jnp.where(
                surf, jnp.maximum(material.roughness, max_roughness), max_roughness
            )
            material = material._replace(
                roughness=jnp.where(surf, max_roughness, material.roughness)
            )

        # ---- stochastic opacity (src/trace.jl:356-364)
        if config.has_opacity:
            r_op, rng = rng_mod.rand1f(rng)
            op_skip = surf & (material.opacity < 1.0) & (r_op >= material.opacity)
            op_dead = op_skip & (s.opbounce > 128)
            alive = alive & ~op_dead
            op_skip = op_skip & ~op_dead
            opbounce = jnp.where(op_skip, s.opbounce + 1, s.opbounce)
            bounce = jnp.where(op_skip, bounce - 1, bounce)
            surf = surf & ~op_skip
        else:
            op_skip = jnp.zeros(n, bool)
            opbounce = s.opbounce

        # ---- first-hit AOVs (src/trace.jl:366-370)
        first = surf & (bounce == 0)
        hit_flag = s.hit_flag | first
        hit_albedo = jnp.where(_vec(first), material.color, s.hit_albedo)
        hit_normal = jnp.where(_vec(first), normal, s.hit_normal)

        # ---- emission (src/trace.jl:372)
        radiance = radiance + jnp.where(
            _vec(surf), weight * eval_ops.eval_emission(material, normal, outgoing), 0.0
        )

        # ---- direction sampling
        r_half, rng = rng_mod.rand1f(rng)
        rnl, rng = rng_mod.rand1f(rng)
        rn, rng = rng_mod.rand2f(rng)
        if is_path and has_lights:
            rl_pick, rng = rng_mod.rand1f(rng)
            rl_el, rng = rng_mod.rand1f(rng)
            rl_uv, rng = rng_mod.rand2f(rng)

        present = config.present_types
        delta = eval_ops.is_delta(material)
        if is_path:
            bsdf_dir = dispatch.sample_bsdfcos(
                material, normal, outgoing, rnl, rn, present=present
            )
            if has_lights:
                light_dir = lights_mod.sample_lights(
                    dscene, dscene.lights, counts, position, rl_pick, rl_el, rl_uv
                )
                nd_incoming = jnp.where(_vec(r_half < 0.5), bsdf_dir, light_dir)
            else:
                nd_incoming = jnp.where(_vec(r_half < 0.5), bsdf_dir, 0.0)
            d_incoming = dispatch.sample_delta(
                material, normal, outgoing, rnl, present=present
            )
            incoming = jnp.where(_vec(delta), d_incoming, nd_incoming)
        else:
            # naive: bsdf-importance only; rough-vs-delta on roughness != 0
            # (src/trace.jl:539-556)
            rough = material.roughness != 0.0
            bsdf_dir = dispatch.sample_bsdfcos(
                material, normal, outgoing, rnl, rn, present=present
            )
            d_incoming = dispatch.sample_delta(
                material, normal, outgoing, rnl, present=present
            )
            incoming = jnp.where(_vec(rough), bsdf_dir, d_incoming)
            delta = ~rough

        # detached sampling: sampled directions are not differentiated —
        # gradients flow through eval_bsdfcos/emission/textures only (the
        # standard detached path-replay estimator)
        incoming = jax.lax.stop_gradient(incoming)
        zero_inc = surf & (jnp.sum(jnp.abs(incoming), axis=-1) == 0.0)
        alive = alive & ~zero_inc
        surf = surf & ~zero_inc

        # ---- volume scatter direction (src/trace.jl:424-440)
        vol = alive & in_volume
        if is_path and config.has_volumes:
            vol_position = s.ro + s.rd * dist[..., None]
            phase_dir = dispatch.sample_scattering(s.vol_density, s.vol_aniso, outgoing, rn)
            if has_lights:
                vol_light_dir = lights_mod.sample_lights(
                    dscene, dscene.lights, counts, vol_position, rl_pick, rl_el, rl_uv
                )
                vol_incoming = jnp.where(_vec(r_half < 0.5), phase_dir, vol_light_dir)
            else:
                vol_incoming = phase_dir
            vol_incoming = jax.lax.stop_gradient(vol_incoming)
            vol_zero = vol & (jnp.sum(jnp.abs(vol_incoming), axis=-1) == 0.0)
            alive = alive & ~vol_zero
            vol = vol & ~vol_zero
        else:
            vol_position = position
            vol_incoming = incoming

        # ---- next ray (opacity skips continue straight, src/trace.jl:361-363)
        new_ro = jnp.where(
            _vec(op_skip),
            position + s.rd * 0.01,
            jnp.where(_vec(vol), vol_position, position),
        )
        new_rd = jnp.where(
            _vec(op_skip), s.rd, jnp.where(_vec(vol), vol_incoming, incoming)
        )

        # ---- wavefront sort BEFORE the traversal (SURVEY §7 step 6):
        # lanes ordered by (liveness, direction octant, morton(origin))
        # so neighbouring lanes share a direction octant and an origin
        # neighbourhood, and dead lanes gather at the tail.
        if do_sort:
            key = _sort_key(new_ro, new_rd, scene_vmin, scene_vmax)
            key = jnp.where(alive, key, 0x7FFFFFFF)
            perm = jnp.argsort(key)
            (new_ro, new_rd, material, normal, outgoing, incoming,
             vol_incoming, delta, surf, vol, op_skip, weight, radiance,
             rng, bounce, opbounce, alive, hit_flag, hit_albedo,
             hit_normal, max_roughness, vd_c, vs_c, va_c, hv_c, idx_c) = (
                jax.tree_util.tree_map(
                    lambda a: a[perm],
                    (new_ro, new_rd, material, normal, outgoing, incoming,
                     vol_incoming, delta, surf, vol, op_skip, weight,
                     radiance, rng, bounce, opbounce, alive, hit_flag,
                     hit_albedo, hit_normal, max_roughness,
                     s.vol_density, s.vol_scattering, s.vol_aniso,
                     s.has_vol, s.idx),
                )
            )
        else:
            vd_c, vs_c, va_c, hv_c, idx_c = (
                s.vol_density, s.vol_scattering, s.vol_aniso, s.has_vol,
                s.idx,
            )

        # ---- ONE traversal: next bounce's hit + light-pdf march step 1.
        # Dead lanes carry tmax = -1, not RAY_EPS: a dead ray whose
        # origin sits inside a bbox still passes the slab test at tiny
        # positive tmax (enter clamps to tmin < exit), while tmax < 0
        # fails every slab test, so dead lanes leave the BVH walk at
        # once. No consumer reads dead lanes' t (every accumulation is
        # gated on `alive`), and exp(-density * t) stays finite for t < 0.
        tmax = jnp.where(alive, F32_MAX, -1.0)
        nxt = intersect(new_ro, new_rd, jnp.full(n, RAY_EPS), tmax)

        # ---- weight updates
        if is_path:
            lights_pdf = (
                lights_mod.sample_lights_pdf(
                    dscene, dscene.lights, counts, intersect,
                    new_ro, new_rd, nxt,
                    extra_steps=options.light_pdf_extra_steps,
                )
                if has_lights
                else jnp.zeros(n, jnp.float32)
            )
            # non-delta surface MIS (src/trace.jl:375-397)
            f_nd = dispatch.eval_bsdfcos(
                material, normal, outgoing, incoming, present=present
            )
            pdf_b = dispatch.sample_bsdfcos_pdf(
                material, normal, outgoing, incoming, present=present
            )
            # pdfs are detached: the sampling measure is not differentiated
            denom_nd = jax.lax.stop_gradient(0.5 * pdf_b + 0.5 * lights_pdf)
            w_nd = f_nd / jnp.maximum(denom_nd, 1e-30)[..., None]
            # delta (src/trace.jl:398-403)
            f_d = dispatch.eval_delta(
                material, normal, outgoing, incoming, present=present
            )
            pdf_d = jax.lax.stop_gradient(
                dispatch.sample_delta_pdf(
                    material, normal, outgoing, incoming, present=present
                )
            )
            w_d = f_d / jnp.maximum(pdf_d, 1e-30)[..., None]
            w_surf = jnp.where(_vec(delta), w_d, w_nd)
            if config.has_volumes:
                # in-volume MIS (src/trace.jl:441-450)
                f_v = dispatch.eval_scattering(
                    vs_c, vd_c, va_c, outgoing, vol_incoming
                )
                pdf_v = dispatch.sample_scattering_pdf(
                    vd_c, va_c, outgoing, vol_incoming
                )
                denom_v = jax.lax.stop_gradient(0.5 * pdf_v + 0.5 * lights_pdf)
                w_vol = f_v / jnp.maximum(denom_v, 1e-30)[..., None]
                weight = jnp.where(
                    _vec(surf),
                    weight * w_surf,
                    jnp.where(_vec(vol), weight * w_vol, weight),
                )
            else:
                weight = jnp.where(_vec(surf), weight * w_surf, weight)
        else:
            f_r = dispatch.eval_bsdfcos(
                material, normal, outgoing, incoming, present=present
            )
            pdf_r = dispatch.sample_bsdfcos_pdf(
                material, normal, outgoing, incoming, present=present
            )
            f_d = dispatch.eval_delta(material, normal, outgoing, incoming, present=present)
            pdf_d = dispatch.sample_delta_pdf(
                material, normal, outgoing, incoming, present=present
            )
            pdf_r = jax.lax.stop_gradient(pdf_r)
            pdf_d = jax.lax.stop_gradient(pdf_d)
            w_r = f_r / jnp.maximum(pdf_r, 1e-30)[..., None]
            w_d = f_d / jnp.maximum(pdf_d, 1e-30)[..., None]
            weight = jnp.where(
                _vec(surf), weight * jnp.where(_vec(delta), w_d, w_r), weight
            )

        # ---- volume stack push/pop (src/trace.jl:405-421)
        vol_density, vol_scattering, vol_aniso, has_vol = (
            vd_c, vs_c, va_c, hv_c,
        )
        if is_path and config.has_volumes:
            transmitted = (
                eval_ops.is_volumetric_type(material.type)
                & (dot(normal, outgoing) * dot(normal, incoming) < 0)
                & surf
            )
            push = transmitted & ~hv_c
            pop = transmitted & hv_c
            vol_density = jnp.where(_vec(push), material.density, vol_density)
            vol_scattering = jnp.where(_vec(push), material.scattering, vol_scattering)
            vol_aniso = jnp.where(push, material.scanisotropy, vol_aniso)
            has_vol = jnp.where(push, True, jnp.where(pop, False, has_vol))

        # ---- weight zero / non-finite break (src/trace.jl:455-457)
        stepped = (surf | vol) & alive
        w_zero = jnp.sum(jnp.abs(weight), axis=-1) == 0.0
        w_bad = ~jnp.all(jnp.isfinite(weight), axis=-1)
        alive = alive & ~(stepped & (w_zero | w_bad))

        # ---- Russian roulette (src/trace.jl:459-465)
        r_rr, rng = rng_mod.rand1f(rng)
        rr_lane = stepped & alive & (bounce > 3)
        rr_prob = jax.lax.stop_gradient(jnp.minimum(0.99, jnp.max(weight, axis=-1)))
        rr_die = rr_lane & (r_rr >= rr_prob)
        alive = alive & ~rr_die
        weight = jnp.where(
            _vec(rr_lane & ~rr_die), weight / jnp.maximum(rr_prob, 1e-30)[..., None], weight
        )

        # ---- loop condition (while bounce < bounces, src/trace.jl:295)
        alive = alive & (bounce < options.bounces)

        new_s = S(
            ro=new_ro,
            rd=new_rd,
            isec_hit=nxt.hit,
            isec_prim=nxt.prim,
            isec_u=nxt.u,
            isec_v=nxt.v,
            isec_t=nxt.t,
            isec_pos=nxt.position,
            isec_gn=nxt.gnormal,
            isec_inst=nxt.instance,
            radiance=radiance,
            weight=weight,
            rng=rng,
            bounce=bounce,
            opbounce=opbounce,
            alive=alive,
            hit_flag=hit_flag,
            hit_albedo=hit_albedo,
            hit_normal=hit_normal,
            max_roughness=max_roughness,
            vol_density=vol_density,
            vol_scattering=vol_scattering,
            vol_aniso=vol_aniso,
            has_vol=has_vol,
            idx=idx_c,
        )
        return new_s

    def cond(s: S):
        return jnp.any(s.alive)

    if alive_trace:
        # diagnostics (tools/alive_profile.py): fixed-trip scan emitting
        # the per-iteration alive count — sizes the dead-lane work the
        # while_loop pays running every lane to the LAST survivor
        def step_dbg(s, _):
            ns = body(s)
            return ns, jnp.sum(ns.alive.astype(jnp.int32))

        final, alive_counts = jax.lax.scan(
            step_dbg, state, None, length=options.bounces + 10
        )
    elif options.fixed_iterations > 0:
        # fixed-trip scan: reverse-mode differentiable; remat each bounce so
        # backward memory stays O(state) per iteration instead of O(residuals)
        step = jax.checkpoint(lambda s, _: (body(s), None))
        final, _ = jax.lax.scan(step, state, None, length=options.fixed_iterations)
    else:
        final = _run_compacted(body, cond, state, n, do_sort, options.compact)
    outs = (final.radiance, final.hit_flag, final.hit_albedo, final.hit_normal, final.rng)
    if do_sort:
        inv = jnp.argsort(final.idx)
        outs = jax.tree_util.tree_map(lambda a: a[inv], outs)
    if alive_trace:
        return outs + (alive_counts,)
    return outs


def _run_compacted(body, cond, state, n, do_sort, compact):
    """Run the bounce loop to completion with survivor compaction.

    The while_loop runs EVERY lane to the LAST survivor's bounce, but the
    alive fraction collapses within a few bounces. Each level drains the
    loop at full width until the survivors fit a narrower buffer, moves
    them there, and continues narrow; the narrow results merge back.
    Dead lanes' outputs are final by construction, so the image is the
    same as the single loop's.

    - sorted wavefronts: the body sorts lanes by liveness every
      iteration and alive only decays within one, so after one extra
      body() every survivor sits in the first <= cap slots: the boundary
      is a slice and the merge a dynamic_update_slice.
    - unsorted wavefronts: a stable argsort of ~alive picks the
      survivors, a gather narrows the state, and a scatter merges the
      five output planes back."""
    kind = "slice" if do_sort else "gather"
    if not compact or n < COMPACT_MIN_LANES:
        return jax.lax.while_loop(cond, body, state)
    div, levels = COMPACT_DIV[kind], COMPACT_LEVELS[kind]

    def _phase_cap(width):
        c = max(COMPACT_MIN_CAP, width // div)
        return -(-c // 128) * 128

    def _drain(cur, c):
        return jax.lax.while_loop(
            lambda s: jnp.sum(s.alive.astype(jnp.int32)) > c, body, cur)

    tm = jax.tree_util.tree_map
    snaps, cur, width = [], state, n
    for _ in range(levels):
        c = _phase_cap(width)
        if c >= width:
            break
        sA = _drain(cur, c)
        if do_sort:
            sA = body(sA)  # packs <= c survivors into the prefix
            sel = None
            cur = tm(lambda a: a[:c], sA)
        else:
            sel = jnp.argsort(~sA.alive, stable=True)[:c]  # alive first
            cur = tm(lambda a: a[sel], sA)
        snaps.append((sA, sel))
        width = c
    final = jax.lax.while_loop(cond, body, cur)
    for sA, sel in reversed(snaps):
        if sel is None:
            final = tm(
                lambda full, nar: jax.lax.dynamic_update_slice(
                    full, nar, (0,) * full.ndim),
                sA, final)
        else:
            final = sA._replace(**{
                f: getattr(sA, f).at[sel].set(getattr(final, f))
                for f in _OUTPUT_FIELDS})
    return final


# state planes trace_wavefront returns (the rest is loop-internal)
_OUTPUT_FIELDS = ("radiance", "hit_flag", "hit_albedo", "hit_normal", "rng")

"""Scene -> flat device arrays (SoA) for wavefront tracing.

Design (not a port): the reference walks pointer-rich nested
structs per ray (src/scene.jl, src/bvh.jl). Here every instance's
primitives are *expanded* into one world-space quad soup so traversal is a
single-level BVH walk with contiguous gathers and zero per-leaf ray
transforms. Triangles use the degenerate-quad convention (a, b, c, c),
which reproduces the reference's own triangle/quad duality exactly
(src/geometry.jl:238-258: intersect_quad with p3 == p4 is
intersect_triangle; quad_normal/area degenerate likewise).

Vertex attributes stay in object space, concatenated across shapes and
indexed by global vertex ids per primitive; normals are rotated by the
instance frame at shading time (one gather per bounce), matching
eval_normal's transform_normal (src/scene.jl:525-576).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from julia_raytracer.scene.types import INVALID_ID, SceneData

# per-prim flag bits
FLAG_HAS_NORMALS = 1
FLAG_HAS_TEXCOORDS = 2
FLAG_HAS_COLORS = 4
FLAG_IS_TRIANGLE_SHAPE = 8  # true triangle mesh (affects light uv warp)


@dataclass
class FlatGeometry:
    """Expanded world-space primitives + concatenated vertex attributes."""

    # per expanded primitive (count Q)
    prim_verts: np.ndarray  # f32 [Q, 4, 3] world-space corners
    prim_vidx: np.ndarray  # i32 [Q, 4] global vertex ids
    prim_instance: np.ndarray  # i32 [Q]
    prim_element: np.ndarray  # i32 [Q] element index within its shape
    prim_flags: np.ndarray  # i32 [Q] FLAG_* bitmask
    # concatenated object-space vertex attributes (count V)
    vert_normals: np.ndarray  # f32 [V, 3] (zeros when absent)
    vert_texcoords: np.ndarray  # f32 [V, 2] (zeros when absent)
    vert_colors: np.ndarray  # f32 [V, 4] (ones when absent)
    vert_positions: np.ndarray  # f32 [V, 3] object space (tangent frames)
    # per instance (count I)
    inst_frame: np.ndarray  # f32 [I, 4, 3]
    inst_material: np.ndarray  # i32 [I]
    inst_shape: np.ndarray  # i32 [I]
    # per shape (count S): expanded bookkeeping for lights
    shape_vert_offset: np.ndarray  # i32 [S+1] into concatenated vertex arrays
    # curve/point primitives, world-space expanded (reference
    # src/geometry.jl:113-172, src/bvh.jl:408-443). Each line end / point
    # carries (tangent-or-normal[3], texcoord[2], color[4]) resolved at
    # flatten time so shading needs no vertex gathers.
    line_verts: np.ndarray = None  # f32 [L, 2, 3]
    line_radius: np.ndarray = None  # f32 [L, 2]
    line_instance: np.ndarray = None  # i32 [L]
    line_attr: np.ndarray = None  # f32 [L, 2, 9]
    point_pos: np.ndarray = None  # f32 [P, 3]
    point_radius: np.ndarray = None  # f32 [P]
    point_instance: np.ndarray = None  # i32 [P]
    point_attr: np.ndarray = None  # f32 [P, 9]


@dataclass
class FlatMaterials:
    type: np.ndarray  # i32 [M]
    emission: np.ndarray  # f32 [M, 3]
    color: np.ndarray  # f32 [M, 3]
    roughness: np.ndarray  # f32 [M]
    metallic: np.ndarray  # f32 [M]
    ior: np.ndarray  # f32 [M]
    scattering: np.ndarray  # f32 [M, 3]
    scanisotropy: np.ndarray  # f32 [M]
    trdepth: np.ndarray  # f32 [M]
    opacity: np.ndarray  # f32 [M]
    emission_tex: np.ndarray  # i32 [M]
    color_tex: np.ndarray  # i32 [M]
    roughness_tex: np.ndarray  # i32 [M]
    scattering_tex: np.ndarray  # i32 [M]
    normal_tex: np.ndarray  # i32 [M]


@dataclass
class FlatTextures:
    """All textures in one flat atlas, row-major per texture."""

    data: np.ndarray  # f32 [sum(w*h), 4] raw values (byte textures /255, no srgb)
    offset: np.ndarray  # i32 [T]
    width: np.ndarray  # i32 [T]
    height: np.ndarray  # i32 [T]
    linear: np.ndarray  # bool [T] True = float/HDR (already linear)


@dataclass
class FlatEnvironments:
    frame: np.ndarray  # f32 [E, 4, 3]
    frame_inv: np.ndarray  # f32 [E, 4, 3] (precomputed rigid inverse)
    emission: np.ndarray  # f32 [E, 3]
    emission_tex: np.ndarray  # i32 [E]


@dataclass
class FlatScene:
    geometry: FlatGeometry
    materials: FlatMaterials
    textures: FlatTextures
    environments: FlatEnvironments
    n_instances: int
    n_shapes: int


def _shape_prims(shape) -> tuple[np.ndarray, bool]:
    """Shape faces as unified quads [P, 4] (0-based) + is-triangle-mesh flag."""
    if len(shape.quads):
        return shape.quads.astype(np.int64), False
    if len(shape.triangles):
        t = shape.triangles.astype(np.int64)
        return np.concatenate([t, t[:, 2:3]], axis=1), True
    return np.zeros((0, 4), np.int64), False


def flatten_scene(scene: SceneData) -> FlatScene:
    S = len(scene.shapes)
    shape_quads = []
    shape_is_tri = np.zeros(S, bool)
    vert_offset = np.zeros(S + 1, np.int64)
    for s, shape in enumerate(scene.shapes):
        q, is_tri = _shape_prims(shape)
        shape_quads.append(q)
        shape_is_tri[s] = is_tri
        vert_offset[s + 1] = vert_offset[s] + len(shape.positions)

    # concatenated vertex attributes (defaults where a shape lacks them)
    def concat_attr(name, width, default):
        parts = []
        for shape in scene.shapes:
            arr = getattr(shape, name)
            n = len(shape.positions)
            if len(arr) == n and n > 0:
                parts.append(arr.astype(np.float32))
            else:
                parts.append(np.full((n, width), default, np.float32))
        return (
            np.concatenate(parts, axis=0)
            if parts
            else np.zeros((0, width), np.float32)
        )

    vert_positions = concat_attr("positions", 3, 0.0)
    vert_normals = concat_attr("normals", 3, 0.0)
    vert_texcoords = concat_attr("texcoords", 2, 0.0)
    vert_colors = concat_attr("colors", 4, 1.0)

    def shape_flags(sid: int) -> int:
        shape = scene.shapes[sid]
        flags = 0
        if len(shape.normals) == len(shape.positions) and len(shape.normals):
            flags |= FLAG_HAS_NORMALS
        if len(shape.texcoords) == len(shape.positions) and len(shape.texcoords):
            flags |= FLAG_HAS_TEXCOORDS
        if len(shape.colors) == len(shape.positions) and len(shape.colors):
            flags |= FLAG_HAS_COLORS
        if shape_is_tri[sid]:
            flags |= FLAG_IS_TRIANGLE_SHAPE
        return flags

    # expand instances to world-space primitives
    pv, pvi, pin, pel, pfl = [], [], [], [], []
    I = len(scene.instances)
    inst_frame = np.zeros((max(I, 1), 4, 3), np.float32)
    inst_material = np.zeros(max(I, 1), np.int32)
    inst_shape = np.zeros(max(I, 1), np.int32)
    for i, inst in enumerate(scene.instances):
        inst_frame[i] = inst.frame
        inst_material[i] = inst.material
        inst_shape[i] = inst.shape
        if inst.shape == INVALID_ID or inst.shape >= S:
            continue
        shape = scene.shapes[inst.shape]
        quads = shape_quads[inst.shape]
        if len(quads) == 0:
            continue
        gidx = quads + vert_offset[inst.shape]
        world = shape.positions[quads.reshape(-1)].reshape(-1, 4, 3)
        rot, org = inst.frame[:3], inst.frame[3]
        world = world @ rot + org  # transform_point (src/math.jl:80-81)
        flags = shape_flags(inst.shape)
        pv.append(world.astype(np.float32))
        pvi.append(gidx.astype(np.int32))
        pin.append(np.full(len(quads), i, np.int32))
        pel.append(np.arange(len(quads), dtype=np.int32))
        pfl.append(np.full(len(quads), flags, np.int32))

    # curve/point primitives. Attr rows: [normal-or-tangent 3, texcoord 2,
    # color 4], resolved per end at flatten time.
    lv, lr, li_, la, pp, pr, pi_, pa = [], [], [], [], [], [], [], []
    for i, inst in enumerate(scene.instances):
        if inst.shape == INVALID_ID or inst.shape >= S:
            continue
        shape = scene.shapes[inst.shape]
        if len(shape.lines) == 0 and len(shape.points) == 0:
            continue
        rot, org = inst.frame[:3], inst.frame[3]
        # world radius scale: mean basis-vector length (1 for rigid)
        rscale = float(np.linalg.norm(rot, axis=1).mean())
        n_verts = len(shape.positions)
        has_n = len(shape.normals) == n_verts and n_verts > 0
        has_tc = len(shape.texcoords) == n_verts and n_verts > 0
        has_c = len(shape.colors) == n_verts and n_verts > 0
        radius = (
            shape.radius
            if len(shape.radius) == n_verts
            else np.full(n_verts, 0.001, np.float32)
        )

        def end_attr(vid):
            a = np.zeros((len(vid), 9), np.float32)
            if has_n:
                a[:, 0:3] = shape.normals[vid] @ rot  # transform_normal
            a[:, 3:5] = shape.texcoords[vid] if has_tc else 0.0
            a[:, 5:9] = shape.colors[vid] if has_c else 1.0
            return a

        if len(shape.lines):
            l_ = shape.lines.astype(np.int64)
            w = shape.positions[l_.reshape(-1)].reshape(-1, 2, 3) @ rot + org
            if not has_n:
                tan = w[:, 1] - w[:, 0]
                tan = tan / np.maximum(
                    np.linalg.norm(tan, axis=1, keepdims=True), 1e-12
                )
            a0, a1 = end_attr(l_[:, 0]), end_attr(l_[:, 1])
            if not has_n:
                a0[:, 0:3] = tan
                a1[:, 0:3] = tan
            lv.append(w.astype(np.float32))
            lr.append(
                (radius[l_] * rscale).astype(np.float32).reshape(-1, 2)
            )
            li_.append(np.full(len(l_), i, np.int32))
            la.append(np.stack([a0, a1], axis=1))
        if len(shape.points):
            p_ = shape.points.astype(np.int64).reshape(-1)
            w = shape.positions[p_] @ rot + org
            ap = end_attr(p_)
            if not has_n:
                ap[:, 0:3] = np.array([0.0, 0.0, 1.0], np.float32)
            pp.append(w.astype(np.float32))
            pr.append((radius[p_] * rscale).astype(np.float32))
            pi_.append(np.full(len(p_), i, np.int32))
            pa.append(ap)

    def cat(parts, empty_shape):
        return (
            np.concatenate(parts, axis=0)
            if parts
            else np.zeros(empty_shape, np.float32)
        )

    line_verts = cat(lv, (0, 2, 3))
    line_radius = cat(lr, (0, 2))
    line_instance = (
        np.concatenate(li_) if li_ else np.zeros(0, np.int32)
    )
    line_attr = cat(la, (0, 2, 9))
    point_pos = cat(pp, (0, 3))
    point_radius = cat(pr, (0,))
    point_instance = (
        np.concatenate(pi_) if pi_ else np.zeros(0, np.int32)
    )
    point_attr = cat(pa, (0, 9))

    if pv:
        prim_verts = np.concatenate(pv, axis=0)
        prim_vidx = np.concatenate(pvi, axis=0)
        prim_instance = np.concatenate(pin, axis=0)
        prim_element = np.concatenate(pel, axis=0)
        prim_flags = np.concatenate(pfl, axis=0)
    else:
        prim_verts = np.zeros((0, 4, 3), np.float32)
        prim_vidx = np.zeros((0, 4), np.int32)
        prim_instance = np.zeros(0, np.int32)
        prim_element = np.zeros(0, np.int32)
        prim_flags = np.zeros(0, np.int32)

    geometry = FlatGeometry(
        prim_verts=prim_verts,
        prim_vidx=prim_vidx,
        prim_instance=prim_instance,
        prim_element=prim_element,
        prim_flags=prim_flags,
        vert_normals=vert_normals,
        vert_texcoords=vert_texcoords,
        vert_colors=vert_colors,
        vert_positions=vert_positions,
        inst_frame=inst_frame,
        inst_material=inst_material,
        inst_shape=inst_shape,
        shape_vert_offset=vert_offset.astype(np.int64),
        line_verts=line_verts,
        line_radius=line_radius,
        line_instance=line_instance,
        line_attr=line_attr,
        point_pos=point_pos,
        point_radius=point_radius,
        point_instance=point_instance,
        point_attr=point_attr,
    )

    M = len(scene.materials)
    mats = FlatMaterials(
        type=np.array([m.type for m in scene.materials], np.int32).reshape(M),
        emission=np.array([m.emission for m in scene.materials], np.float32).reshape(M, 3),
        color=np.array([m.color for m in scene.materials], np.float32).reshape(M, 3),
        roughness=np.array([m.roughness for m in scene.materials], np.float32).reshape(M),
        metallic=np.array([m.metallic for m in scene.materials], np.float32).reshape(M),
        ior=np.array([m.ior for m in scene.materials], np.float32).reshape(M),
        scattering=np.array([m.scattering for m in scene.materials], np.float32).reshape(M, 3),
        scanisotropy=np.array([m.scanisotropy for m in scene.materials], np.float32).reshape(M),
        trdepth=np.array([m.trdepth for m in scene.materials], np.float32).reshape(M),
        opacity=np.array([m.opacity for m in scene.materials], np.float32).reshape(M),
        emission_tex=np.array([m.emission_tex for m in scene.materials], np.int32).reshape(M),
        color_tex=np.array([m.color_tex for m in scene.materials], np.int32).reshape(M),
        roughness_tex=np.array([m.roughness_tex for m in scene.materials], np.int32).reshape(M),
        scattering_tex=np.array([m.scattering_tex for m in scene.materials], np.int32).reshape(M),
        normal_tex=np.array([m.normal_tex for m in scene.materials], np.int32).reshape(M),
    )

    T = len(scene.textures)
    sizes = [t.width * t.height for t in scene.textures]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    tex = FlatTextures(
        data=(
            np.concatenate([t.pixels for t in scene.textures], axis=0)
            if T
            else np.zeros((0, 4), np.float32)
        ),
        offset=offsets[:-1].astype(np.int32) if T else np.zeros(0, np.int32),
        width=np.array([t.width for t in scene.textures], np.int32).reshape(T),
        height=np.array([t.height for t in scene.textures], np.int32).reshape(T),
        linear=np.array([t.linear for t in scene.textures], bool).reshape(T),
    )

    E = len(scene.environments)
    env_frames = np.array(
        [e.frame for e in scene.environments], np.float32
    ).reshape(E, 4, 3)
    # rigid inverse: transpose rotation (src/math.jl:95-103)
    inv = np.zeros_like(env_frames)
    for i in range(E):
        rot = env_frames[i, :3]
        minv = rot.T
        inv[i, :3] = minv
        inv[i, 3] = -(env_frames[i, 3] @ minv)
    envs = FlatEnvironments(
        frame=env_frames,
        frame_inv=inv,
        emission=np.array([e.emission for e in scene.environments], np.float32).reshape(E, 3),
        emission_tex=np.array([e.emission_tex for e in scene.environments], np.int32).reshape(E),
    )

    return FlatScene(
        geometry=geometry,
        materials=mats,
        textures=tex,
        environments=envs,
        n_instances=I,
        n_shapes=S,
    )

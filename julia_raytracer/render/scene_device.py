"""Device-resident scene: every array the integrator touches, as one pytree.

Built from the host FlatScene (scene/flatten.py) + the BVH permutation:
primitive arrays are reordered to BVH leaf order once, on host, so
traversal and shading share the same indices with zero indirection.
Being a NamedTuple-of-arrays, the whole scene threads through jit
boundaries, shards (replicated) over a device mesh, and participates in
autodiff — material/texture/emission arrays are differentiable leaves.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from julia_raytracer.ops.bvh import FlatBVH, build_bvh, quad_bounds
from julia_raytracer.render.lights import (
    DeviceLights, LightCounts, build_lights_np,
)
from julia_raytracer.scene.flatten import FlatScene, flatten_scene


class DeviceMaterials(NamedTuple):
    type: jnp.ndarray  # i32 [M]
    emission: jnp.ndarray  # f32 [M, 3]
    color: jnp.ndarray  # f32 [M, 3]
    roughness: jnp.ndarray
    metallic: jnp.ndarray
    ior: jnp.ndarray
    scattering: jnp.ndarray  # [M, 3]
    scanisotropy: jnp.ndarray
    trdepth: jnp.ndarray
    opacity: jnp.ndarray
    emission_tex: jnp.ndarray  # i32
    color_tex: jnp.ndarray
    roughness_tex: jnp.ndarray
    scattering_tex: jnp.ndarray
    normal_tex: jnp.ndarray


class DeviceTextures(NamedTuple):
    data: jnp.ndarray  # f32 [P, 4]
    offset: jnp.ndarray  # i32 [T]
    width: jnp.ndarray  # i32 [T]
    height: jnp.ndarray  # i32 [T]
    linear: jnp.ndarray  # bool [T]


class DeviceScene(NamedTuple):
    """All scene arrays, primitive arrays in BVH leaf order."""

    # geometry (sorted by BVH order)
    prim_verts: jnp.ndarray  # f32 [Q, 4, 3]
    prim_vidx: jnp.ndarray  # i32 [Q, 4]
    prim_instance: jnp.ndarray  # i32 [Q]
    prim_flags: jnp.ndarray  # i32 [Q]
    nodes: jnp.ndarray  # f32 [Nn, 16] packed BVH
    # vertex attributes (concatenated across shapes)
    vert_normals: jnp.ndarray
    vert_texcoords: jnp.ndarray
    vert_colors: jnp.ndarray
    # instances
    inst_frame: jnp.ndarray  # f32 [I, 4, 3]
    inst_material: jnp.ndarray  # i32 [I]
    # tables
    materials: DeviceMaterials
    textures: DeviceTextures
    # environments
    env_frame: jnp.ndarray  # f32 [E, 4, 3]
    env_frame_inv: jnp.ndarray
    env_emission: jnp.ndarray  # f32 [E, 3]
    env_emission_tex: jnp.ndarray  # i32 [E]
    # lights
    lights: DeviceLights
    # per-instance material constants folded to one row (gather-free
    # material eval for small scenes): [I, 21] =
    # [type, emission*3, color*3, roughness, metallic, ior,
    #  scattering*3, scanisotropy, trdepth, opacity,
    #  emission_tex, color_tex, roughness_tex, scattering_tex, normal_tex]
    inst_mat_dense: jnp.ndarray
    # curve/point primitives, world space (src/geometry.jl:113-172;
    # attr rows = [normal-or-tangent 3, texcoord 2, color 4])
    line_verts: jnp.ndarray  # f32 [L, 2, 3]
    line_radius: jnp.ndarray  # f32 [L, 2]
    line_instance: jnp.ndarray  # i32 [L]
    line_attr: jnp.ndarray  # f32 [L, 2, 9]
    point_pos: jnp.ndarray  # f32 [P, 3]
    point_radius: jnp.ndarray  # f32 [P]
    point_instance: jnp.ndarray  # i32 [P]
    point_attr: jnp.ndarray  # f32 [P, 9]


class SceneConfig(NamedTuple):
    """Static (compile-time) facts about the scene.

    The feature flags drive scene-specialized compilation: the integrator
    statically drops material lobes, texture paths, normal mapping,
    opacity, and volume machinery the scene cannot exercise — the
    replacement for the reference's per-ray dynamic dispatch (a
    cornellbox kernel compiles to matte-only straight-line code)."""

    n_prims: int
    root_is_leaf: bool
    n_envs: int
    light_counts: LightCounts
    has_normal_maps: bool
    has_opacity: bool
    present_types: tuple = tuple(range(8))  # sorted MaterialType ints present
    n_instances: int = 0
    has_textures: bool = True
    has_vertex_normals: bool = True
    has_texcoords: bool = True
    has_colors: bool = True
    has_volumes: bool = True
    # curve/point primitive counts (0 = paths statically absent)
    n_lines: int = 0
    n_points: int = 0


def _opt(a, shape, dtype=np.float32) -> np.ndarray:
    """None-safe array default (older FlatGeometry pickles lack curves)."""
    return a if a is not None else np.zeros(shape, dtype)


def _inst_mat_dense(g, m) -> np.ndarray:
    """Fold the instance -> material indirection into one packed f32 row
    per instance (texture-free constants only)."""
    i_count = max(len(g.inst_material), 1)
    out = np.zeros((i_count, 21), np.float32)
    out[:, 16:21] = -1.0  # texture ids default to "none"
    if len(m.type) == 0:
        return out
    mid = np.clip(g.inst_material, 0, len(m.type) - 1)
    out[: len(mid), 0] = m.type[mid]
    out[: len(mid), 1:4] = m.emission[mid]
    out[: len(mid), 4:7] = m.color[mid]
    out[: len(mid), 7] = m.roughness[mid]
    out[: len(mid), 8] = m.metallic[mid]
    out[: len(mid), 9] = m.ior[mid]
    out[: len(mid), 10:13] = m.scattering[mid]
    out[: len(mid), 13] = m.scanisotropy[mid]
    out[: len(mid), 14] = m.trdepth[mid]
    out[: len(mid), 15] = m.opacity[mid]
    out[: len(mid), 16] = m.emission_tex[mid]
    out[: len(mid), 17] = m.color_tex[mid]
    out[: len(mid), 18] = m.roughness_tex[mid]
    out[: len(mid), 19] = m.scattering_tex[mid]
    out[: len(mid), 20] = m.normal_tex[mid]
    return out


def build_device_scene(
    scene_data, highquality_bvh: bool = False, cache_key: str = "",
) -> tuple[DeviceScene, SceneConfig]:
    """Host SceneData -> (DeviceScene, SceneConfig). Flattens every
    instance to world space, builds the BVH, reorders primitives, and
    assembles the light table."""
    from julia_raytracer.utils import diskcache

    flat = flatten_scene(scene_data)
    g = flat.geometry

    cached = diskcache.load_arrays(cache_key, "geom")
    if cached is not None and int(cached["n_prims"]) == len(g.prim_verts):
        # BVH + light tables + sorted primitive arrays straight from disk
        host_prim_verts = cached["prim_verts"]
        host_prim_instance = cached["prim_instance"]
        sorted_vidx = cached["prim_vidx"]
        sorted_flags = cached["prim_flags"]
        nodes_np = cached["nodes"]
        n_prims = int(cached["n_prims"])
        root_is_leaf = bool(cached["root_is_leaf"])
        lights = DeviceLights(
            **{k: jnp.asarray(cached["L_" + k]) for k in DeviceLights._fields}
        )
        light_counts = LightCounts(
            n_instance=int(cached["c_n_instance"]),
            n_env=int(cached["c_n_env"]),
            max_inst_elems=int(cached["c_max_inst_elems"]),
            max_env_texels=int(cached["c_max_env_texels"]),
            total_inst_elems=int(cached["c_total_inst_elems"]),
        )
    else:
        bb_min, bb_max = quad_bounds(g.prim_verts)
        tree: FlatBVH = build_bvh(bb_min, bb_max, sah=highquality_bvh)
        order = tree.order

        def sort(a):
            return a[order] if len(order) else a

        lights_np, light_counts = build_lights_np(flat, order)
        lights = DeviceLights(**{k: jnp.asarray(v) for k, v in lights_np.items()})
        host_prim_verts = sort(g.prim_verts)
        host_prim_instance = sort(g.prim_instance)
        sorted_vidx = sort(g.prim_vidx)
        sorted_flags = sort(g.prim_flags)
        nodes_np = tree.nodes
        n_prims = tree.n_prims
        root_is_leaf = tree.root_is_leaf
        if cache_key and n_prims > 200_000:  # heavy scenes only
            save = dict(
                prim_verts=host_prim_verts,
                prim_instance=host_prim_instance,
                prim_vidx=sorted_vidx,
                prim_flags=sorted_flags,
                nodes=nodes_np,
                n_prims=n_prims,
                root_is_leaf=root_is_leaf,
                c_n_instance=light_counts.n_instance,
                c_n_env=light_counts.n_env,
                c_max_inst_elems=light_counts.max_inst_elems,
                c_max_env_texels=light_counts.max_env_texels,
                c_total_inst_elems=light_counts.total_inst_elems,
            )
            for k, v in lights_np.items():
                save["L_" + k] = v
            diskcache.save_arrays(cache_key, "geom", save)

    return _assemble(
        flat,
        host_prim_verts=host_prim_verts,
        host_prim_instance=host_prim_instance,
        sorted_vidx=sorted_vidx,
        sorted_flags=sorted_flags,
        nodes_np=nodes_np,
        n_prims=n_prims,
        root_is_leaf=root_is_leaf,
        lights=lights,
        light_counts=light_counts,
    )


def _assemble(
    flat, *, host_prim_verts, host_prim_instance, sorted_vidx, sorted_flags,
    nodes_np, n_prims, root_is_leaf, lights, light_counts,
) -> tuple[DeviceScene, SceneConfig]:
    """Tail of the device-scene build: upload arrays and derive the static
    SceneConfig."""
    g = flat.geometry
    m = flat.materials
    t = flat.textures
    e = flat.environments

    dscene = DeviceScene(
        prim_verts=jnp.asarray(host_prim_verts),
        prim_vidx=jnp.asarray(sorted_vidx),
        prim_instance=jnp.asarray(host_prim_instance),
        prim_flags=jnp.asarray(sorted_flags),
        nodes=jnp.asarray(nodes_np),
        vert_normals=jnp.asarray(g.vert_normals),
        vert_texcoords=jnp.asarray(g.vert_texcoords),
        vert_colors=jnp.asarray(g.vert_colors),
        inst_frame=jnp.asarray(g.inst_frame),
        inst_material=jnp.asarray(np.maximum(g.inst_material, 0)),
        materials=DeviceMaterials(
            type=jnp.asarray(m.type),
            emission=jnp.asarray(m.emission),
            color=jnp.asarray(m.color),
            roughness=jnp.asarray(m.roughness),
            metallic=jnp.asarray(m.metallic),
            ior=jnp.asarray(m.ior),
            scattering=jnp.asarray(m.scattering),
            scanisotropy=jnp.asarray(m.scanisotropy),
            trdepth=jnp.asarray(m.trdepth),
            opacity=jnp.asarray(m.opacity),
            emission_tex=jnp.asarray(m.emission_tex),
            color_tex=jnp.asarray(m.color_tex),
            roughness_tex=jnp.asarray(m.roughness_tex),
            scattering_tex=jnp.asarray(m.scattering_tex),
            normal_tex=jnp.asarray(m.normal_tex),
        ),
        textures=DeviceTextures(
            data=jnp.asarray(t.data),
            offset=jnp.asarray(t.offset),
            width=jnp.asarray(t.width),
            height=jnp.asarray(t.height),
            linear=jnp.asarray(t.linear),
        ),
        env_frame=jnp.asarray(e.frame),
        env_frame_inv=jnp.asarray(e.frame_inv),
        env_emission=jnp.asarray(e.emission),
        env_emission_tex=jnp.asarray(e.emission_tex),
        lights=lights,
        inst_mat_dense=jnp.asarray(_inst_mat_dense(g, m)),
        line_verts=jnp.asarray(_opt(g.line_verts, (0, 2, 3))),
        line_radius=jnp.asarray(_opt(g.line_radius, (0, 2))),
        line_instance=jnp.asarray(_opt(g.line_instance, (0,), np.int32)),
        line_attr=jnp.asarray(_opt(g.line_attr, (0, 2, 9))),
        point_pos=jnp.asarray(_opt(g.point_pos, (0, 3))),
        point_radius=jnp.asarray(_opt(g.point_radius, (0,))),
        point_instance=jnp.asarray(_opt(g.point_instance, (0,), np.int32)),
        point_attr=jnp.asarray(_opt(g.point_attr, (0, 9))),
    )
    from julia_raytracer.scene.flatten import (
        FLAG_HAS_COLORS,
        FLAG_HAS_NORMALS,
        FLAG_HAS_TEXCOORDS,
    )

    flags_union = int(np.bitwise_or.reduce(g.prim_flags)) if len(g.prim_flags) else 0
    # opacity can also come from a color texture's alpha channel
    any_tex_alpha = bool((t.data[:, 3] < 1.0).any()) if len(t.data) else False
    present = tuple(sorted(set(int(x) for x in m.type))) if len(m.type) else ()
    config = SceneConfig(
        n_prims=n_prims,
        root_is_leaf=root_is_leaf,
        n_envs=len(e.emission),
        light_counts=light_counts,
        has_normal_maps=bool((m.normal_tex >= 0).any()) if len(m.normal_tex) else False,
        has_opacity=(
            bool((m.opacity < 1.0).any()) if len(m.opacity) else False
        ) or any_tex_alpha,
        present_types=present,
        n_instances=flat.n_instances,
        has_textures=len(t.data) > 0,
        has_vertex_normals=bool(flags_union & FLAG_HAS_NORMALS),
        has_texcoords=bool(flags_union & FLAG_HAS_TEXCOORDS),
        has_colors=bool(flags_union & FLAG_HAS_COLORS),
        has_volumes=bool(set(present) & {4, 5, 6}),  # refractive/subsurface/volumetric
        n_lines=len(_opt(g.line_instance, (0,), np.int32)),
        n_points=len(_opt(g.point_instance, (0,), np.int32)),
    )
    return dscene, config

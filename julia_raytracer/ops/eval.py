"""Surface evaluation at hit points (gather-based wavefront shading).

Given (prim, u, v) hits from traversal, these produce world position,
shading normal (incl. normal mapping and the refractive-orientation
quirk), interpolated attributes, and the MaterialPoint used by the
integrators. Semantics follow the reference scene-eval layer
(src/scene.jl:416-891) with primitives unified as quads (triangles are
degenerate quads, see scene/flatten.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from julia_raytracer.ops import texture as tex_ops
from julia_raytracer.ops.geometry import (
    interpolate_quad,
    quad_normal,
    triangle_tangents_fromuv,
)
from julia_raytracer.scene.flatten import (
    FLAG_HAS_COLORS,
    FLAG_HAS_NORMALS,
    FLAG_HAS_TEXCOORDS,
)
from julia_raytracer.scene.types import MaterialType, MIN_ROUGHNESS
from julia_raytracer.utils.vecmath import (
    cross,
    dot,
    mat_mul_vec,
    normalize,
    orthonormalize,
    transform_normal,
)


class MaterialPoint(NamedTuple):
    """Per-lane evaluated material (src/scene.jl:266-320)."""

    type: jnp.ndarray  # i32 [N]
    emission: jnp.ndarray  # f32 [N, 3]
    color: jnp.ndarray  # f32 [N, 3]
    opacity: jnp.ndarray  # f32 [N]
    roughness: jnp.ndarray  # f32 [N]
    metallic: jnp.ndarray  # f32 [N]
    ior: jnp.ndarray  # f32 [N]
    density: jnp.ndarray  # f32 [N, 3]
    scattering: jnp.ndarray  # f32 [N, 3]
    scanisotropy: jnp.ndarray  # f32 [N]
    trdepth: jnp.ndarray  # f32 [N]


def gather_prim(scene, prim):
    """Gather per-prim data for hit lanes: verts [N,4,3], vidx, instance, flags."""
    return (
        scene.prim_verts[prim],
        scene.prim_vidx[prim],
        scene.prim_instance[prim],
        scene.prim_flags[prim],
    )


def eval_position(verts, u, v):
    """World hit position via quad interpolation (src/scene.jl:435-476)."""
    return interpolate_quad(verts[..., 0, :], verts[..., 1, :], verts[..., 2, :], verts[..., 3, :], u, v)


def eval_texcoord(scene, vidx, flags, u, v):
    """Interpolated texcoord; uv passthrough when absent (src/scene.jl:753-788)."""
    tc = scene.vert_texcoords[vidx]  # [N,4,2]
    out = interpolate_quad(tc[..., 0, :], tc[..., 1, :], tc[..., 2, :], tc[..., 3, :], u, v)
    has = (flags & FLAG_HAS_TEXCOORDS) != 0
    return jnp.where(has[..., None], out, jnp.stack([u, v], axis=-1))


def eval_color_attr(scene, vidx, flags, u, v):
    """Interpolated vertex color; white when absent (src/scene.jl:690-720)."""
    c = scene.vert_colors[vidx]  # [N,4,4]
    out = interpolate_quad(c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :], u, v)
    has = (flags & FLAG_HAS_COLORS) != 0
    return jnp.where(has[..., None], out, 1.0)


def eval_element_normal(verts):
    """Geometric normal from world verts (src/scene.jl:578-612). Degenerate
    quads (c==d) reduce to the triangle normal exactly as in the reference."""
    return quad_normal(verts[..., 0, :], verts[..., 1, :], verts[..., 2, :], verts[..., 3, :])


def eval_normal(scene, gnormal, vidx, inst, flags, u, v, with_vertex_normals=True):
    """Interpolated shading normal, world space (src/scene.jl:525-576).

    `gnormal` is the precomputed element normal (from the intersector);
    `with_vertex_normals=False` (scene-specialized: no shape has vertex
    normals) statically skips the gather + interpolation."""
    if not with_vertex_normals:
        return gnormal
    vn = scene.vert_normals[vidx]  # [N,4,3]
    interp = normalize(
        interpolate_quad(vn[..., 0, :], vn[..., 1, :], vn[..., 2, :], vn[..., 3, :], u, v)
    )
    frame = scene.inst_frame[inst]
    world = transform_normal(frame, interp)
    has = (flags & FLAG_HAS_NORMALS) != 0
    return jnp.where(has[..., None], world, gnormal)


def eval_element_tangents(scene, verts, vidx, flags):
    """UV tangents of the element's first triangle (src/scene.jl:851-891).

    verts are already world-space so no frame transform is needed; the
    reference computes object tangents then rotates, which is equivalent
    for its rigid frames.
    """
    tc = scene.vert_texcoords[vidx]
    tu, tv = triangle_tangents_fromuv(
        verts[..., 0, :], verts[..., 1, :], verts[..., 3, :],
        tc[..., 0, :], tc[..., 1, :], tc[..., 3, :],
    )
    return normalize(tu), normalize(tv)


def eval_normalmap(scene, normal, texcoord, normal_tex, verts, vidx, flags):
    """Tangent-space normal mapping (src/scene.jl:722-751)."""
    nm = tex_ops.eval_texture(scene.textures, normal_tex, texcoord, as_linear=False)
    normalmap = nm[..., :3] * 2.0 - 1.0
    tu, tv = eval_element_tangents(scene, verts, vidx, flags)
    f1 = orthonormalize(tu, normal)
    f2 = normalize(cross(normal, f1))
    flip_v = dot(f2, tv) < 0.0
    n2 = normalmap[..., 1] * jnp.where(flip_v, 1.0, -1.0)
    nm_vec = jnp.stack([normalmap[..., 0], n2, normalmap[..., 2]], axis=-1)
    frame = jnp.stack([f1, f2, normal], axis=-2)
    mapped = normalize(mat_mul_vec(frame, nm_vec))
    has_tc = (flags & FLAG_HAS_TEXCOORDS) != 0
    apply = (normal_tex >= 0) & has_tc
    return jnp.where(apply[..., None], mapped, normal)


def eval_shading_normal(
    scene, gnormal, verts, vidx, inst, flags, u, v, outgoing, mat_type, normal_tex,
    texcoord, with_normalmap=True, with_vertex_normals=True, refractive_present=True,
):
    """Full shading-normal pipeline (src/scene.jl:479-523): vertex normal,
    optional normal map, faceforward — except refractive materials keep
    the geometric orientation (src/scene.jl:504-506). The with_* flags
    statically drop stages the scene cannot exercise. `verts` may be None
    when with_normalmap is False (only the tangent path needs it)."""
    normal = eval_normal(
        scene, gnormal, vidx, inst, flags, u, v,
        with_vertex_normals=with_vertex_normals,
    )
    if with_normalmap:
        normal = eval_normalmap(scene, normal, texcoord, normal_tex, verts, vidx,
                                flags)
    forward = jnp.where(dot(normal, outgoing)[..., None] >= 0.0, normal, -normal)
    if not refractive_present:
        return forward
    keep = mat_type == MaterialType.REFRACTIVE
    return jnp.where(keep[..., None], normal, forward)


def eval_material(scene, inst, texcoord, shp_color):
    """Evaluate the MaterialPoint (src/scene.jl:615-673): texture
    modulation, roughness^2 + min-roughness clamp, density from trdepth."""
    mid = scene.inst_material[inst]
    m = scene.materials
    mtype = m.type[mid]

    emission_tex = tex_ops.eval_texture(scene.textures, m.emission_tex[mid], texcoord, as_linear=True)
    color_tex = tex_ops.eval_texture(scene.textures, m.color_tex[mid], texcoord, as_linear=True)
    roughness_tex = tex_ops.eval_texture(scene.textures, m.roughness_tex[mid], texcoord, as_linear=False)
    scattering_tex = tex_ops.eval_texture(scene.textures, m.scattering_tex[mid], texcoord, as_linear=True)

    emission = m.emission[mid] * emission_tex[..., :3]
    color = m.color[mid] * color_tex[..., :3] * shp_color[..., :3]
    opacity = m.opacity[mid] * color_tex[..., 3] * shp_color[..., 3]
    metallic = m.metallic[mid] * roughness_tex[..., 2]
    roughness = m.roughness[mid] * roughness_tex[..., 1]
    roughness = roughness * roughness
    ior = m.ior[mid]
    scattering = m.scattering[mid] * scattering_tex[..., :3]
    scanisotropy = m.scanisotropy[mid]
    trdepth = m.trdepth[mid]

    volumetric_like = (
        (mtype == MaterialType.REFRACTIVE)
        | (mtype == MaterialType.VOLUMETRIC)
        | (mtype == MaterialType.SUBSURFACE)
    )
    density = jnp.where(
        volumetric_like[..., None],
        -jnp.log(jnp.clip(color, 1e-4, 1.0)) / trdepth[..., None],
        0.0,
    )

    clamp_min = (
        (mtype == MaterialType.MATTE)
        | (mtype == MaterialType.GLTFPBR)
        | (mtype == MaterialType.GLOSSY)
    )
    roughness = jnp.where(
        clamp_min,
        jnp.clip(roughness, MIN_ROUGHNESS, 1.0),
        jnp.where(
            mtype == MaterialType.VOLUMETRIC,
            0.0,
            jnp.where(roughness < MIN_ROUGHNESS, 0.0, roughness),
        ),
    )

    return MaterialPoint(
        type=mtype,
        emission=emission,
        color=color,
        opacity=opacity,
        roughness=roughness,
        metallic=metallic,
        ior=ior,
        density=density,
        scattering=scattering,
        scanisotropy=scanisotropy,
        trdepth=trdepth,
    )


def eval_material_dense(scene, inst, shp_color, n_instances: int):
    """Gather-free eval_material for small UNTEXTURED scenes: the
    instance->material indirection is folded into scene.inst_mat_dense
    [I, 16] and resolved with a compare-select chain instead of a
    per-lane gather.

    Texture-modulation terms are identity by construction (no textures),
    so the result matches eval_material exactly. NOT used in
    differentiable mode: gradients flow through scene.materials, which
    this table shadows."""
    from julia_raytracer.utils.vecmath import select_rows

    row = select_rows(scene.inst_mat_dense, inst, n_instances)  # [N, 16]
    mtype = row[..., 0].astype(jnp.int32)
    emission = row[..., 1:4]
    color = row[..., 4:7] * shp_color[..., :3]
    opacity = row[..., 15] * shp_color[..., 3]
    roughness = row[..., 7] ** 2
    metallic = row[..., 8]
    ior = row[..., 9]
    scattering = row[..., 10:13]
    scanisotropy = row[..., 13]
    trdepth = row[..., 14]

    volumetric_like = (
        (mtype == MaterialType.REFRACTIVE)
        | (mtype == MaterialType.VOLUMETRIC)
        | (mtype == MaterialType.SUBSURFACE)
    )
    density = jnp.where(
        volumetric_like[..., None],
        -jnp.log(jnp.clip(color, 1e-4, 1.0)) / trdepth[..., None],
        0.0,
    )
    clamp_min = (
        (mtype == MaterialType.MATTE)
        | (mtype == MaterialType.GLTFPBR)
        | (mtype == MaterialType.GLOSSY)
    )
    roughness = jnp.where(
        clamp_min,
        jnp.clip(roughness, MIN_ROUGHNESS, 1.0),
        jnp.where(
            mtype == MaterialType.VOLUMETRIC,
            0.0,
            jnp.where(roughness < MIN_ROUGHNESS, 0.0, roughness),
        ),
    )
    return MaterialPoint(
        type=mtype, emission=emission, color=color, opacity=opacity,
        roughness=roughness, metallic=metallic, ior=ior, density=density,
        scattering=scattering, scanisotropy=scanisotropy, trdepth=trdepth,
    )


def eval_material_rows(scene, rows, texcoord, shp_color):
    """eval_material from a pre-selected [N, 21] dense-material row
    (constants + texture ids; see scene_device.inst_mat_dense) — the
    textured counterpart of eval_material_dense: only the 4 texture
    evaluations still gather; all table indirection is select-based."""
    mtype = rows[..., 0].astype(jnp.int32)
    e_tex = rows[..., 16].astype(jnp.int32)
    c_tex = rows[..., 17].astype(jnp.int32)
    r_tex = rows[..., 18].astype(jnp.int32)
    s_tex = rows[..., 19].astype(jnp.int32)

    emission_tex = tex_ops.eval_texture(scene.textures, e_tex, texcoord, as_linear=True)
    color_tex = tex_ops.eval_texture(scene.textures, c_tex, texcoord, as_linear=True)
    roughness_tex = tex_ops.eval_texture(scene.textures, r_tex, texcoord, as_linear=False)
    scattering_tex = tex_ops.eval_texture(scene.textures, s_tex, texcoord, as_linear=True)

    emission = rows[..., 1:4] * emission_tex[..., :3]
    color = rows[..., 4:7] * color_tex[..., :3] * shp_color[..., :3]
    opacity = rows[..., 15] * color_tex[..., 3] * shp_color[..., 3]
    metallic = rows[..., 8] * roughness_tex[..., 2]
    roughness = rows[..., 7] * roughness_tex[..., 1]
    roughness = roughness * roughness
    ior = rows[..., 9]
    scattering = rows[..., 10:13] * scattering_tex[..., :3]
    scanisotropy = rows[..., 13]
    trdepth = rows[..., 14]

    volumetric_like = (
        (mtype == MaterialType.REFRACTIVE)
        | (mtype == MaterialType.VOLUMETRIC)
        | (mtype == MaterialType.SUBSURFACE)
    )
    density = jnp.where(
        volumetric_like[..., None],
        -jnp.log(jnp.clip(color, 1e-4, 1.0)) / trdepth[..., None],
        0.0,
    )
    clamp_min = (
        (mtype == MaterialType.MATTE)
        | (mtype == MaterialType.GLTFPBR)
        | (mtype == MaterialType.GLOSSY)
    )
    roughness = jnp.where(
        clamp_min,
        jnp.clip(roughness, MIN_ROUGHNESS, 1.0),
        jnp.where(
            mtype == MaterialType.VOLUMETRIC,
            0.0,
            jnp.where(roughness < MIN_ROUGHNESS, 0.0, roughness),
        ),
    )
    return MaterialPoint(
        type=mtype, emission=emission, color=color, opacity=opacity,
        roughness=roughness, metallic=metallic, ior=ior, density=density,
        scattering=scattering, scanisotropy=scanisotropy, trdepth=trdepth,
    )


def is_delta(material: MaterialPoint):
    """src/scene.jl:916-920."""
    t, r = material.type, material.roughness
    return (
        ((t == MaterialType.REFLECTIVE) & (r == 0.0))
        | ((t == MaterialType.REFRACTIVE) & (r == 0.0))
        | ((t == MaterialType.TRANSPARENT) & (r == 0.0))
        | (t == MaterialType.VOLUMETRIC)
    )


def is_volumetric_type(mtype):
    """src/scene.jl:925-928 (on the base material type)."""
    return (
        (mtype == MaterialType.REFRACTIVE)
        | (mtype == MaterialType.VOLUMETRIC)
        | (mtype == MaterialType.SUBSURFACE)
    )


def eval_emission(material: MaterialPoint, normal, outgoing):
    """src/trace.jl:575-580."""
    facing = dot(normal, outgoing) >= 0.0
    return jnp.where(facing[..., None], material.emission, 0.0)


def eval_environment(scene, direction):
    """Sum of all environment contributions (src/scene.jl:893-914)."""
    n_envs = scene.env_frame.shape[0] if scene.env_frame is not None else 0
    total = jnp.zeros(direction.shape, jnp.float32)[..., :3]
    for e in range(n_envs):
        wl = transform_normal(scene.env_frame_inv[e], direction)
        tx = jnp.arctan2(wl[..., 2], wl[..., 0]) / (2.0 * jnp.pi)
        tx = jnp.where(tx < 0.0, tx + 1.0, tx)
        ty = jnp.arccos(jnp.clip(wl[..., 1], -1.0, 1.0)) / jnp.pi
        texcoord = jnp.stack([tx, ty], axis=-1)
        tid = jnp.full(direction.shape[:-1], scene.env_emission_tex[e], jnp.int32)
        emis = tex_ops.eval_texture(scene.textures, tid, texcoord, as_linear=True)
        total = total + scene.env_emission[e] * emis[..., :3]
    return total

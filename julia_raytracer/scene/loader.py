"""Yocto-style JSON scene loader (host side, numpy).

Data contract from the reference (src/sceneio.jl:25-93, src/scene.jl):
top-level keys asset/cameras/textures/materials/shapes/instances/
environments/subdivs; shapes & textures are {"uri": ...} file references;
cross-references are 0-based indices; optional `lookat` (9 floats:
eye, center, up) overrides `frame` (12 floats, row-major x/y/z/o rows).

Loading of textures and shapes fans out over a thread pool, mirroring the
reference's Threads.@threads loops (src/sceneio.jl:534,556).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from julia_raytracer.scene import ply
from julia_raytracer.scene.types import (
    INVALID_ID,
    MATERIAL_TYPES,
    CameraData,
    EnvironmentData,
    InstanceData,
    MaterialData,
    SceneData,
    ShapeData,
    SubdivData,
    TextureData,
)
from julia_raytracer.utils import vecmath
from julia_raytracer.utils.imgio import load_hdr_rgba, load_png_rgba


def _parse_frame(values) -> np.ndarray:
    vals = np.asarray(values, np.float32).reshape(-1)
    if vals.size != 12:  # src/math.jl:47-54: wrong size -> identity
        return np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]], np.float32)
    return vals.reshape(4, 3)


def _lookat_frame(lookat, inv_xz: bool) -> np.ndarray:
    l = np.asarray(lookat, np.float32).reshape(3, 3)
    eye, center, up = l[0], l[1], l[2]
    frame = np.asarray(
        vecmath.lookat_frame(eye, center, up, inv_xz=inv_xz), np.float32
    )
    return frame, float(np.linalg.norm(eye - center))


def _camera_from_json(j) -> CameraData:
    cam = CameraData(
        frame=_parse_frame(j.get("frame", [])),
        orthographic=bool(j.get("orthographic", False)),
        lens=float(j.get("lens", 0.050)),
        film=float(j.get("film", 0.036)),
        aspect=float(j.get("aspect", 1.5)),
        focus=float(j.get("focus", 10000)),
        aperture=float(j.get("aperture", 0)),
        name=j.get("name", ""),
    )
    if "lookat" in j:  # src/scene.jl:67-83: focus = |eye - center|
        cam.frame, cam.focus = _lookat_frame(j["lookat"], inv_xz=False)
    return cam


def _instance_from_json(j) -> InstanceData:
    inst = InstanceData(
        frame=_parse_frame(j.get("frame", [])),
        shape=int(j.get("shape", INVALID_ID)),
        material=int(j.get("material", INVALID_ID)),
    )
    if "lookat" in j:  # src/scene.jl:97-112 (inv_xz=true)
        inst.frame, _ = _lookat_frame(j["lookat"], inv_xz=True)
    return inst


def _environment_from_json(j) -> EnvironmentData:
    env = EnvironmentData(
        frame=_parse_frame(j.get("frame", [])),
        emission=np.asarray(j.get("emission", [0, 0, 0]), np.float32),
        emission_tex=int(j.get("emission_tex", INVALID_ID)),
    )
    if "lookat" in j:  # src/scene.jl:126-141 (inv_xz=true)
        env.frame, _ = _lookat_frame(j["lookat"], inv_xz=True)
    return env


def _material_from_json(j) -> MaterialData:
    return MaterialData(
        type=MATERIAL_TYPES.get(j.get("type", "matte"), MATERIAL_TYPES["matte"]),
        emission=np.asarray(j.get("emission", [0, 0, 0]), np.float32),
        color=np.asarray(j.get("color", [0, 0, 0]), np.float32),
        roughness=float(j.get("roughness", 0)),
        metallic=float(j.get("metallic", 0)),
        ior=float(j.get("ior", 1.5)),
        scattering=np.asarray(j.get("scattering", [0, 0, 0]), np.float32),
        scanisotropy=float(j.get("scanisotropy", 0)),
        trdepth=float(j.get("trdepth", 0.01)),
        opacity=float(j.get("opacity", 1)),
        emission_tex=int(j.get("emission_tex", INVALID_ID)),
        color_tex=int(j.get("color_tex", INVALID_ID)),
        roughness_tex=int(j.get("roughness_tex", INVALID_ID)),
        scattering_tex=int(j.get("scattering_tex", INVALID_ID)),
        normal_tex=int(j.get("normal_tex", INVALID_ID)),
    )


def load_texture(path: str) -> TextureData:
    """PNG (byte, sRGB) or HDR (float, linear) -> TextureData
    (src/scene.jl:164-189; HDR loaded correctly, unlike the reference).

    A missing file falls back to a 1x1 mid-gray placeholder so the
    scene stays renderable."""
    ext = os.path.splitext(path)[1].lower()
    if not os.path.exists(path):
        import sys

        print(f"warning: missing texture {path}; using placeholder", file=sys.stderr)
        return TextureData(
            width=1, height=1, linear=ext == ".hdr",
            pixels=np.array([[0.5, 0.5, 0.5, 1.0]], np.float32),
        )
    if ext == ".hdr":
        img = load_hdr_rgba(path)
        linear = True
    elif ext == ".png":
        img = load_png_rgba(path).astype(np.float32) / 255.0
        linear = False
    else:
        raise ValueError(f"unknown texture format: {ext}")
    h, w = img.shape[:2]
    return TextureData(width=w, height=h, linear=linear,
                       pixels=img.reshape(h * w, 4).astype(np.float32))


def load_shape(path: str) -> ShapeData:
    """Binary PLY -> ShapeData (src/shape.jl:78-124), 0-based indices.

    Texcoords come from u/v (or s/t) with the v axis flipped
    (src/shape.jl:233-237); colors from red/green/blue[/alpha].
    """
    if os.path.splitext(path)[1].lower() != ".ply":
        raise ValueError(f"unsupported shape format: {path}")
    if not os.path.exists(path):
        import sys

        print(f"warning: missing shape {path}; using empty shape", file=sys.stderr)
        return ShapeData()
    elements = ply.read_ply(path)
    shape = ShapeData()
    vert = elements.get("vertex")
    if vert is not None:
        d = vert.data

        def col(*names, default=None):
            if all(n in d for n in names):
                return np.stack([d[n].astype(np.float32) for n in names], axis=-1)
            return default

        pos = col("x", "y", "z")
        if pos is not None:
            shape.positions = pos
        nrm = col("nx", "ny", "nz")
        if nrm is not None:
            shape.normals = nrm
        for u_name, v_name in (("u", "v"), ("s", "t")):
            tc = col(u_name, v_name)
            if tc is not None:
                tc[:, 1] = 1.0 - tc[:, 1]  # flip v (src/shape.jl:233-234)
                shape.texcoords = tc
                break
        rgba = col("red", "green", "blue", "alpha")
        if rgba is None:
            rgb = col("red", "green", "blue")
            if rgb is not None:
                rgba = np.concatenate(
                    [rgb, np.ones((len(rgb), 1), np.float32)], axis=-1
                )
        if rgba is not None:
            # byte colors normalize to [0,1]
            if vert.properties and any(
                n in ("red",) and dt == "u1" for n, dt in vert.properties
            ):
                rgba = rgba / 255.0
            shape.colors = rgba.astype(np.float32)
        if "radius" in d:
            shape.radius = d["radius"].astype(np.float32)

    if "face" in elements:
        tris, quads, _ = ply.parse_faces(elements["face"])
        shape.triangles, shape.quads = tris, quads
    if "line" in elements:
        shape.lines = ply.parse_lines(elements["line"])
    if "point" in elements and elements["point"].list_data is not None:
        shape.points = elements["point"].list_data.astype(np.int32)
    return shape


def load_scene(filename: str, parallel: bool = True) -> SceneData:
    """JSON scene + referenced PLY/PNG/HDR assets -> SceneData."""
    scene_dir = os.path.dirname(filename)
    with open(filename) as f:
        j = json.load(f)
    scene = SceneData()
    scene.cameras = [_camera_from_json(c) for c in j.get("cameras", [])]
    scene.materials = [_material_from_json(m) for m in j.get("materials", [])]
    scene.instances = [_instance_from_json(i) for i in j.get("instances", [])]
    scene.environments = [_environment_from_json(e) for e in j.get("environments", [])]
    for s in j.get("subdivs", []):
        scene.subdivs.append(
            SubdivData(
                subdivisions=int(s.get("subdivisions", 0)),
                catmullclark=bool(s.get("catmullclark", True)),
                smooth=bool(s.get("smooth", True)),
                displacement=float(s.get("displacement", 0)),
                displacement_tex=int(s.get("displacement_tex", INVALID_ID)),
                shape=int(s.get("shape", INVALID_ID)),
                uri=os.path.join(scene_dir, s["uri"]) if "uri" in s else "",
            )
        )

    tex_uris = [os.path.join(scene_dir, t["uri"]) for t in j.get("textures", [])]
    shp_uris = [os.path.join(scene_dir, s["uri"]) for s in j.get("shapes", [])]
    if parallel and (len(tex_uris) + len(shp_uris)) > 1:
        with ThreadPoolExecutor() as pool:
            tex_f = [pool.submit(load_texture, u) for u in tex_uris]
            shp_f = [pool.submit(load_shape, u) for u in shp_uris]
            scene.textures = [f.result() for f in tex_f]
            scene.shapes = [f.result() for f in shp_f]
    else:
        scene.textures = [load_texture(u) for u in tex_uris]
        scene.shapes = [load_shape(u) for u in shp_uris]
    _apply_subdivs(scene)
    return scene


def _apply_subdivs(scene: SceneData) -> None:
    """Tessellate subdiv control cages (scene/subdiv.py) and replace the
    referenced shapes. Opt-in via JRT_TESSELLATE=1 — the corpus ships
    pre-tessellated PLYs so the default path renders those, exactly like
    the reference — but a shape whose PLY blob is stripped (empty) gets
    tessellated automatically when its cage OBJ survives."""
    force = os.environ.get("JRT_TESSELLATE", "") == "1"
    for sd in scene.subdivs:
        if not (0 <= sd.shape < len(scene.shapes)) or not sd.uri:
            continue
        shape = scene.shapes[sd.shape]
        empty = len(shape.positions) == 0
        if not (force or empty):
            continue
        if not os.path.exists(sd.uri):
            continue
        if not sd.catmullclark:
            continue
        from julia_raytracer.scene.subdiv import tessellate_subdiv

        disp_tex = None
        if (
            sd.displacement != 0.0
            and 0 <= sd.displacement_tex < len(scene.textures)
        ):
            disp_tex = scene.textures[sd.displacement_tex]
        try:
            pos, quads, normals, texcoords = tessellate_subdiv(
                sd.uri, sd.subdivisions, sd.smooth,
                displacement=sd.displacement, disp_tex=disp_tex,
            )
        except Exception as e:
            import sys

            print(f"warning: subdiv tessellation failed for {sd.uri}: {e}",
                  file=sys.stderr)
            continue
        if len(shape.texcoords) and texcoords is None:
            import sys

            print(
                f"warning: subdiv cage {sd.uri} has no texcoords; the "
                "tessellated shape loses its UVs",
                file=sys.stderr,
            )
        shape.positions = pos
        shape.quads = quads
        shape.triangles = np.zeros((0, 3), np.int32)
        shape.normals = (
            normals if normals is not None else np.zeros((0, 3), np.float32)
        )
        shape.texcoords = (
            texcoords  # already in the internal (flipped-v) convention
            if texcoords is not None
            else np.zeros((0, 2), np.float32)
        )
        shape.colors = np.zeros((0, 4), np.float32)


def find_camera(scene: SceneData, name: str, camera_names: list[str] | None = None) -> int:
    """Camera lookup with Yocto fallback names (src/scene.jl:358-370).

    Returns a 0-based camera index (INVALID_ID when the scene has none).
    """
    if not scene.cameras:
        return INVALID_ID
    for candidate in [name, "default", "camera", "camera0", "camera1"]:
        for i, cam in enumerate(scene.cameras):
            if cam.name == candidate:
                return i
    return 0

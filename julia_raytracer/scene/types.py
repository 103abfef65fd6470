"""Host-side scene model (numpy), mirroring the reference data contract.

These are the CPU-resident structures produced by the JSON/PLY/texture
loaders (reference: src/scene.jl:48-356, src/shape.jl:13-48). The device-
side flat representation lives in julia_raytracer.ops.flatten.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

INVALID_ID = -1
MIN_ROUGHNESS = 0.03 * 0.03  # src/scene.jl:46


class MaterialType(enum.IntEnum):
    """Material lobes (src/scene.jl:191-211); JSON "volume" maps to VOLUMETRIC."""

    MATTE = 0
    GLOSSY = 1
    REFLECTIVE = 2
    TRANSPARENT = 3
    REFRACTIVE = 4
    SUBSURFACE = 5
    VOLUMETRIC = 6
    GLTFPBR = 7


MATERIAL_TYPES = {
    "matte": MaterialType.MATTE,
    "glossy": MaterialType.GLOSSY,
    "reflective": MaterialType.REFLECTIVE,
    "transparent": MaterialType.TRANSPARENT,
    "refractive": MaterialType.REFRACTIVE,
    "subsurface": MaterialType.SUBSURFACE,
    "volume": MaterialType.VOLUMETRIC,
    "volumetric": MaterialType.VOLUMETRIC,
    "gltfpbr": MaterialType.GLTFPBR,
}


def _identity_frame() -> np.ndarray:
    return np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, 0]], np.float32)


@dataclass
class CameraData:
    """Thin-lens/orthographic camera (src/scene.jl:48-86)."""

    frame: np.ndarray = field(default_factory=_identity_frame)  # [4,3]
    orthographic: bool = False
    lens: float = 0.050
    film: float = 0.036
    aspect: float = 1.5
    focus: float = 10000.0
    aperture: float = 0.0
    name: str = ""


@dataclass
class InstanceData:
    """Rigid transform + shape + material ids (src/scene.jl:88-115)."""

    frame: np.ndarray = field(default_factory=_identity_frame)
    shape: int = INVALID_ID
    material: int = INVALID_ID


@dataclass
class EnvironmentData:
    """Spherical environment light (src/scene.jl:117-144)."""

    frame: np.ndarray = field(default_factory=_identity_frame)
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    emission_tex: int = INVALID_ID


@dataclass
class TextureData:
    """One texture image; byte data is raw sRGB (src/scene.jl:146-162)."""

    width: int = 0
    height: int = 0
    linear: bool = False  # True for HDR (float data already linear)
    # float32 [H*W, 4]; byte textures are stored as byte/255 WITHOUT srgb
    # decode, matching lookup_texture's lazy decode (src/scene.jl:836-849)
    pixels: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))


@dataclass
class MaterialData:
    """Material constants + texture ids (src/scene.jl:213-264)."""

    type: MaterialType = MaterialType.MATTE
    emission: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    roughness: float = 0.0
    metallic: float = 0.0
    ior: float = 1.5
    scattering: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    scanisotropy: float = 0.0
    trdepth: float = 0.01
    opacity: float = 1.0
    emission_tex: int = INVALID_ID
    color_tex: int = INVALID_ID
    roughness_tex: int = INVALID_ID
    scattering_tex: int = INVALID_ID
    normal_tex: int = INVALID_ID


@dataclass
class ShapeData:
    """Indexed mesh with optional per-vertex attributes (src/shape.jl:13-48).

    Indices are 0-based. `quads` uses the degenerate convention
    (a, b, c, c) for triangles embedded in quad meshes.
    """

    points: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    lines: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.int32))
    triangles: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.int32))
    quads: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.int32))
    positions: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    normals: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    texcoords: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    colors: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    radius: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))


@dataclass
class SubdivData:
    """Catmull-Clark subdiv description. The reference never loads these
    (src/sceneio.jl:73 todo) and renders the pre-tessellated PLYs Yocto
    exported alongside; scene/subdiv.py can tessellate the cage for real
    (JRT_TESSELLATE=1, or automatically when the PLY blob is stripped)."""

    subdivisions: int = 0
    catmullclark: bool = True
    smooth: bool = True
    displacement: float = 0.0
    displacement_tex: int = INVALID_ID
    shape: int = INVALID_ID
    uri: str = ""  # control-cage OBJ path (for tessellation)


@dataclass
class SceneData:
    cameras: list[CameraData] = field(default_factory=list)
    instances: list[InstanceData] = field(default_factory=list)
    environments: list[EnvironmentData] = field(default_factory=list)
    shapes: list[ShapeData] = field(default_factory=list)
    textures: list[TextureData] = field(default_factory=list)
    materials: list[MaterialData] = field(default_factory=list)
    subdivs: list[SubdivData] = field(default_factory=list)

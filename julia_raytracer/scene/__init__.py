from julia_raytracer.scene.types import (  # noqa: F401
    CameraData,
    EnvironmentData,
    InstanceData,
    MaterialData,
    MaterialType,
    SceneData,
    ShapeData,
    TextureData,
)
from julia_raytracer.scene.loader import load_scene, find_camera  # noqa: F401

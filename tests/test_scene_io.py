"""Scene/PLY/texture loading contract tests on the generated scenes
(julia_raytracer.scene.generate)."""

import os

import numpy as np
import pytest

from julia_raytracer.scene.loader import find_camera, load_scene, load_shape
from julia_raytracer.scene.flatten import flatten_scene
from julia_raytracer.scene.types import MaterialType


def test_cornellbox_counts(cornellbox):
    s = cornellbox
    assert len(s.cameras) == 1
    assert len(s.shapes) == 8
    assert len(s.materials) == 8
    assert len(s.instances) == 8
    # 36 faces total across shapes (PLY headers); all triangle meshes
    total = sum(len(sh.quads) + len(sh.triangles) for sh in s.shapes)
    assert total == 36
    assert all(len(sh.quads) == 0 for sh in s.shapes)


def test_cornellbox_camera(cornellbox):
    cam = cornellbox.cameras[0]
    assert cam.name == "camera1"
    assert cam.aspect == pytest.approx(1.0)
    assert cam.lens == pytest.approx(0.035, rel=1e-5)
    assert cam.film == pytest.approx(0.024, rel=1e-4)
    assert cam.focus == pytest.approx(3.9, rel=1e-5)
    np.testing.assert_allclose(cam.frame[3], [0, 1, 3.9], rtol=1e-6)
    assert find_camera(cornellbox, "") == 0


def test_cornellbox_materials(cornellbox):
    mats = cornellbox.materials
    assert all(m.type == MaterialType.MATTE for m in mats)
    light = mats[4]
    np.testing.assert_allclose(light.emission, [17, 12, 4])
    assert mats[0].ior == pytest.approx(1.5)
    assert mats[0].trdepth == pytest.approx(0.01)
    assert mats[0].opacity == pytest.approx(1.0)


def test_ply_triangle_pair(scene_file):
    root = os.path.dirname(scene_file("cornellbox"))
    shape = load_shape(f"{root}/shapes/light.ply")
    assert shape.positions.shape == (4, 3)
    assert shape.triangles.shape == (2, 3)
    assert shape.quads.shape == (0, 4)
    assert shape.triangles.min() >= 0 and shape.triangles.max() <= 3


def test_ply_triangle_shape_with_attrs(scene_file):
    root = os.path.dirname(scene_file("envmap"))
    shape = load_shape(f"{root}/shapes/sphere.ply")
    # a 96 x 64 quad grid over a (97 x 65)-vertex UV sphere
    assert shape.positions.shape == (6305, 3)
    assert shape.normals.shape == (6305, 3)
    assert shape.texcoords.shape == (6305, 2)
    assert len(shape.quads) == 6144 and len(shape.triangles) == 0
    # normals should be ~unit length
    lens = np.linalg.norm(shape.normals, axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-3)


def test_flatten_cornellbox(cornellbox):
    flat = flatten_scene(cornellbox)
    g = flat.geometry
    assert g.prim_verts.shape == (36, 4, 3)
    assert g.prim_instance.shape == (36,)
    assert g.inst_frame.shape == (8, 4, 3)
    # identity frames -> world verts equal object verts
    v0 = cornellbox.shapes[0].positions
    np.testing.assert_allclose(
        g.vert_positions[: len(v0)], v0, rtol=1e-6
    )
    assert flat.materials.type.shape == (8,)
    np.testing.assert_allclose(flat.materials.emission[4], [17, 12, 4])


def test_flatten_instanced_scene(rng):
    from julia_raytracer.scene.types import InstanceData, SceneData, ShapeData

    shapes = [ShapeData(positions=rng.normal(size=(30, 3)).astype(np.float32),
                        triangles=rng.integers(0, 30, (n, 3)).astype(np.int32))
              for n in (4000, 2147)]
    frames = [np.concatenate([np.eye(3), [[2.0 * i, 0, 0]]]).astype(np.float32)
              for i in range(5)]
    scene = SceneData(
        shapes=shapes,
        instances=[InstanceData(frame=f, shape=i % 2, material=0)
                   for i, f in enumerate(frames)])
    flat = flatten_scene(scene)
    # 5 instances reuse 2 shapes: 3 x 4000 + 2 x 2147 world prims
    assert flat.geometry.prim_verts.shape[0] == 3 * 4000 + 2 * 2147
    assert flat.n_instances == len(scene.instances)
    # world-space transform applied: instance 3 is shape 1 moved by +6 x
    g = flat.geometry
    sel = g.prim_instance == 3
    want = shapes[1].positions[shapes[1].triangles[:, 0]] + [6.0, 0, 0]
    np.testing.assert_allclose(g.prim_verts[sel][:, 0], want, rtol=1e-6)


def test_environment_scene(scene_file):
    scene = load_scene(scene_file("envmap"))
    assert len(scene.environments) == 1
    env = scene.environments[0]
    assert env.emission_tex == 0
    np.testing.assert_allclose(env.emission, [0.5, 0.5, 0.5])
    tex = scene.textures[0]
    assert tex.linear  # HDR
    assert tex.width > 0 and tex.pixels.shape[0] == tex.width * tex.height
    # real HDR: should have values > 1 (reference's loader clamps; ours must not)
    assert tex.pixels[:, :3].max() > 1.0

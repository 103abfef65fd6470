"""The seeded scene generator (scene/generate.py): same seed, same
bytes; every scene loads through `load_scene`; the heavy tier matches
the statistics it stands in for."""

import os

import numpy as np
import pytest

from julia_raytracer.scene import generate
from julia_raytracer.scene.loader import load_scene
from julia_raytracer.scene.types import MaterialType


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("name", ["cornellbox", "envmap", "manylights"])
def test_same_seed_same_bytes(tmp_path, name):
    a = generate.generate(name, seed=5, root=str(tmp_path / "a"))
    b = generate.generate(name, seed=5, root=str(tmp_path / "b"))
    ta, tb = _tree_bytes(os.path.dirname(a)), _tree_bytes(os.path.dirname(b))
    assert ta.keys() == tb.keys() and ta == tb


def test_seed_changes_the_scene(tmp_path):
    a = generate.generate("manylights", seed=1, root=str(tmp_path))
    b = generate.generate("manylights", seed=2, root=str(tmp_path))
    assert _tree_bytes(os.path.dirname(a)) != _tree_bytes(os.path.dirname(b))


@pytest.mark.parametrize("name", ["cornellbox", "envmap", "manylights"])
def test_scene_loads(scene_file, name):
    scene = load_scene(scene_file(name))
    assert scene.cameras and scene.instances and scene.materials
    for inst in scene.instances:
        sh = scene.shapes[inst.shape]
        faces = sh.triangles if len(sh.triangles) else sh.quads
        assert len(faces) and faces.max() < len(sh.positions)
    assert any(np.asarray(m.emission).max() > 0 for m in scene.materials) or scene.environments


def test_ensure_scene_regenerates_when_absent(tmp_path):
    path = generate.ensure_scene("cornellbox", root=str(tmp_path))
    assert os.path.exists(path)
    os.remove(path)
    assert generate.ensure_scene("cornellbox", root=str(tmp_path)) == path
    assert os.path.exists(path)


def test_kitchen_class_statistics(tmp_path):
    """The heavy tier: ~1.44M triangles over 299 shapes, quad area
    lights, matte + glossy + refractive materials."""
    scene = load_scene(generate.generate("kitchen_class", root=str(tmp_path)))
    assert len(scene.shapes) == generate.KITCHEN_SHAPES
    n_tris = sum(len(s.triangles) for s in scene.shapes)
    assert abs(n_tris - generate.KITCHEN_TRIANGLES) < 0.02 * generate.KITCHEN_TRIANGLES
    types = {m.type for m in scene.materials}
    assert {MaterialType.MATTE, MaterialType.GLOSSY, MaterialType.REFRACTIVE} <= types
    lights = [i for i in scene.instances
              if np.asarray(scene.materials[i.material].emission).max() > 0]
    assert len(lights) == 4
    for i in lights:
        assert len(scene.shapes[i.shape].triangles) == 2  # one quad each

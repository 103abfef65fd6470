"""Catmull-Clark subdivision tessellation (beyond reference — the
reference never loads subdivs, src/sceneio.jl:73), checked on a cube
control cage written by the test: topology, closure, symmetry,
face-varying texcoord seams, the loader's opt-in path and displacement.
(The comparisons against Yocto's exported tessellations of the
reference corpus cages went with the corpus, which is not in the repo.)"""

import json
import os

import numpy as np
import pytest

from julia_raytracer.scene.objio import load_obj_cage
from julia_raytracer.scene.subdiv import catmull_clark, tessellate_subdiv

_CUBE_V = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
           (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
_CUBE_F = [(1, 4, 3, 2), (5, 6, 7, 8), (1, 2, 6, 5), (2, 3, 7, 6),
           (3, 4, 8, 7), (4, 1, 5, 8)]


@pytest.fixture(scope="module")
def cube_obj(tmp_path_factory):
    """Unit-cube cage; every face has its own 4 texcoords (all seams)."""
    path = tmp_path_factory.mktemp("cage") / "cube.obj"
    lines = [f"v {x} {y} {z}" for x, y, z in _CUBE_V]
    for k in range(6):
        u0 = k / 6
        lines += [f"vt {u0} 0", f"vt {u0 + 1 / 6} 0", f"vt {u0 + 1 / 6} 1", f"vt {u0} 1"]
    for k, f in enumerate(_CUBE_F):
        lines.append("f " + " ".join(f"{v}/{4 * k + j + 1}" for j, v in enumerate(f)))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _edges(quads):
    e = np.sort(np.stack([quads, np.roll(quads, -1, axis=1)], -1).reshape(-1, 2), 1)
    return np.unique(e, axis=0, return_counts=True)[1]


def test_cube_level1_topology(cube_obj):
    pos, faces, ns, uvs, vtf = load_obj_cage(cube_obj)
    assert faces.shape == (6, 4) and (ns == 4).all()
    p1, q1 = catmull_clark(pos, faces, ns, 1)
    # closed cube: 8 updated + 6 face + 12 edge verts, 24 quads
    assert p1.shape == (26, 3)
    assert q1.shape == (24, 4)
    assert (_edges(q1) == 2).all()  # watertight


def test_cube_level4_closed_symmetric_and_shrinking(cube_obj):
    pos, faces, ns, _, _ = load_obj_cage(cube_obj)
    prev = np.abs(pos).max()
    for level in (1, 2, 3, 4):
        p, q = catmull_clark(pos, faces, ns, level)
        assert len(q) == 6 * 4**level
        assert (_edges(q) == 2).all()
        # the limit surface lies inside the cage and shrinks level by level
        r = np.abs(p).max()
        assert r <= prev + 1e-6
        prev = r
        # the cube's mirror symmetries map the point set onto itself
        key = lambda a: np.unique(np.round(a, 5), axis=0)
        for axis in range(3):
            m = p.copy()
            m[:, axis] *= -1
            np.testing.assert_array_equal(key(m), key(p))


def test_cube_fvar_texcoords_split_at_seams(cube_obj):
    pos, quads, nrm, tc = tessellate_subdiv(cube_obj, 3, True)
    p_geo, _ = catmull_clark(*load_obj_cage(cube_obj)[:3], 3)
    assert tc is not None and len(tc) == len(pos)
    # every face's uv island is separate, so seam vertices are split
    assert len(pos) > len(p_geo)
    assert tc.min() >= -1e-6 and tc.max() <= 1 + 1e-6
    # split vertices are copies of geometric ones
    geo = {tuple(v) for v in np.round(p_geo, 5)}
    assert {tuple(v) for v in np.round(pos, 5)} == geo
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=1), 1.0, atol=1e-4)


def test_loader_tessellates_on_optin(monkeypatch, tmp_path, cube_obj):
    from julia_raytracer.scene.generate import write_ply
    from julia_raytracer.scene.loader import load_scene

    os.makedirs(tmp_path / "shapes")
    os.makedirs(tmp_path / "subdivs")
    (tmp_path / "subdivs" / "cube.obj").write_text(open(cube_obj).read())
    write_ply(str(tmp_path / "shapes" / "cube.ply"), np.asarray(_CUBE_V, np.float32),
              np.asarray(_CUBE_F, np.int32) - 1)
    scene_json = {
        "shapes": [{"uri": "shapes/cube.ply"}],
        "subdivs": [{"uri": "subdivs/cube.obj", "shape": 0, "subdivisions": 4,
                     "catmullclark": True, "smooth": True}],
        "materials": [{"type": "matte"}],
        "instances": [{"shape": 0, "material": 0}],
    }
    path = tmp_path / "scene.json"
    path.write_text(json.dumps(scene_json))
    monkeypatch.setenv("JRT_TESSELLATE", "1")
    sh = load_scene(str(path)).shapes[0]
    assert len(sh.quads) == 6 * 4**4
    assert len(sh.normals) == len(sh.positions)
    # default path: the PLY is rendered as written (reference behavior)
    monkeypatch.delenv("JRT_TESSELLATE")
    assert len(load_scene(str(path)).shapes[0].quads) == 6


def test_displacement_moves_surface(cube_obj):
    from julia_raytracer.scene.types import TextureData

    flat = TextureData(
        width=2, height=2, linear=True,
        pixels=np.full((4, 4), 1.0, np.float32),
    )
    p0, q0, n0, t0 = tessellate_subdiv(cube_obj, 2, True)
    p1, q1, n1, t1 = tessellate_subdiv(
        cube_obj, 2, True, displacement=0.05, disp_tex=flat,
    )
    d = np.linalg.norm(p1 - p0, axis=1)
    np.testing.assert_allclose(d, 0.05, atol=1e-5)  # uniform outward push

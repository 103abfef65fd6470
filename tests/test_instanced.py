"""Instanced scenes flatten to world space and take the one-level path.

The renderer's intersector on a flattened instanced scene must agree
with a brute-force test over world prims expanded independently here
(numpy: instance frame applied to every shape vertex), including the
instance id of each hit, its material, and its geometric normal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.ops.geometry import RAY_EPS
from julia_raytracer.ops.traversal import intersect_bruteforce
from julia_raytracer.render.integrator import make_intersect
from julia_raytracer.render.scene_device import build_device_scene
from julia_raytracer.scene.generate import _displaced_shape, _rotation
from julia_raytracer.scene.types import (
    InstanceData, MaterialData, SceneData, ShapeData,
)


def _scene(seed, n_instances):
    rng = np.random.default_rng(seed)
    shapes = []
    for n_tris in (300, 120, 40):
        p, t, _, _ = _displaced_shape(rng, n_tris)
        shapes.append(ShapeData(positions=p, triangles=t))
    materials = [MaterialData(color=rng.uniform(0.1, 0.9, 3).astype(np.float32))
                 for _ in range(4)]
    instances = []
    for i in range(n_instances):
        rot = _rotation(rng) * rng.uniform(0.3, 0.8)
        org = rng.uniform(-2.5, 2.5, 3)
        instances.append(InstanceData(
            frame=np.concatenate([rot, org[None]]).astype(np.float32),
            shape=int(rng.integers(0, 3)), material=int(rng.integers(0, 4))))
    return SceneData(shapes=shapes, materials=materials, instances=instances)


def _world_prims(scene):
    """(verts [P,4,3], instance [P]) expanded without scene/flatten.py."""
    verts, owner = [], []
    for i, inst in enumerate(scene.instances):
        sh = scene.shapes[inst.shape]
        tri = sh.triangles
        local = sh.positions[np.concatenate([tri, tri[:, 2:3]], axis=1)]
        world = local.astype(np.float64) @ inst.frame[:3] + inst.frame[3]
        verts.append(world.astype(np.float32))
        owner.append(np.full(len(tri), i, np.int32))
    return np.concatenate(verts), np.concatenate(owner)


@pytest.mark.parametrize("n_instances", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flattened_instances_match_expanded_bruteforce(seed, n_instances):
    scene = _scene(seed, n_instances)
    dscene, config = build_device_scene(scene)
    wv, owner = _world_prims(scene)
    assert config.n_prims == len(wv) and config.n_instances == n_instances

    rng = np.random.default_rng(100 + seed)
    n = 512
    ro = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    ro[:, 2] = 6.0
    # aim at the instances: a random instance's origin, jittered
    origins = np.array([inst.frame[3] for inst in scene.instances])
    target = (origins[rng.integers(0, n_instances, n)]
              + rng.uniform(-0.6, 0.6, (n, 3))).astype(np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro, rd = jnp.asarray(ro), jnp.asarray(rd)
    tmin, tmax = jnp.full(n, RAY_EPS), jnp.full(n, 3.4e38)

    got = make_intersect(dscene, config)(ro, rd, tmin, tmax)
    ref = intersect_bruteforce(jnp.asarray(wv), ro, rd, tmin, tmax,
                               prim_instance=jnp.asarray(owner))
    hit = np.asarray(ref.hit)
    assert hit.sum() > 20
    np.testing.assert_array_equal(np.asarray(got.hit), hit)
    np.testing.assert_allclose(np.asarray(got.t)[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    inst_got = np.asarray(got.instance)[hit]
    np.testing.assert_array_equal(inst_got, np.asarray(ref.instance)[hit])
    mats = np.array([inst.material for inst in scene.instances])
    np.testing.assert_array_equal(
        np.asarray(dscene.inst_material)[inst_got], mats[inst_got])
    # geometric normals agree up to orientation-preserving rounding
    np.testing.assert_allclose(np.asarray(got.gnormal)[hit],
                               np.asarray(ref.gnormal)[hit], atol=2e-4)

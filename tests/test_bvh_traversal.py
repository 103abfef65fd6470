"""BVH build + wavefront traversal vs brute force ground truth."""

import jax.numpy as jnp
import numpy as np

from julia_raytracer.ops import bvh as bvh_mod
from julia_raytracer.ops.geometry import RAY_EPS
from julia_raytracer.ops.traversal import intersect_bruteforce, intersect_bvh
from julia_raytracer.scene.flatten import flatten_scene


def random_tri_soup(rng, n):
    base = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    tris = np.stack([base, base + e1, base + e2, base + e2], axis=1)
    return tris  # degenerate quads (c == d) = triangles


def random_rays(rng, n):
    ro = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return jnp.asarray(ro), jnp.asarray(rd)


def test_leaf_encoding_roundtrip():
    start = np.array([0, 5, 123456], np.int64)
    count = np.array([1, 4, 7], np.int64)
    code = bvh_mod.encode_leaf(start, count)
    assert (code < 0).all()
    s, c = bvh_mod.decode_leaf(code)
    np.testing.assert_array_equal(s, start)
    np.testing.assert_array_equal(c, count)


def test_bvh_vs_bruteforce_random(rng):
    prims = random_tri_soup(rng, 1200)
    tree = bvh_mod.build_bvh(*bvh_mod.quad_bounds(prims))
    assert not tree.root_is_leaf
    sorted_prims = prims[tree.order]

    ro, rd = random_rays(rng, 256)
    tmin = jnp.full(256, RAY_EPS)
    tmax = jnp.full(256, 3.4e38)

    bh, bp, bu, bv, bt = intersect_bruteforce(jnp.asarray(sorted_prims), ro, rd, tmin, tmax)[:5]
    th, tp, tu, tv, tt = intersect_bvh(
        jnp.asarray(tree.nodes), jnp.asarray(sorted_prims), ro, rd, tmin, tmax
    )[:5]
    np.testing.assert_array_equal(np.asarray(bh), np.asarray(th))
    hits = np.asarray(bh)
    assert hits.sum() > 30  # sanity: the soup is dense enough to hit
    np.testing.assert_allclose(
        np.asarray(bt)[hits], np.asarray(tt)[hits], rtol=1e-5
    )
    # same primitive except exact-tie cases
    same = np.asarray(bp)[hits] == np.asarray(tp)[hits]
    assert same.mean() > 0.999


def test_bvh_cornellbox_scene(cornellbox):
    flat = flatten_scene(cornellbox)
    prims = flat.geometry.prim_verts
    tree = bvh_mod.build_bvh(*bvh_mod.quad_bounds(prims), leaf_size=2)
    sorted_prims = prims[tree.order]

    rng = np.random.default_rng(3)
    n = 256
    # rays from the camera position toward the box
    # narrow fan: the camera is OUTSIDE the open box (z=3.9 vs box z in
    # [-1,1]), so wide rays legitimately escape without hitting anything
    ro = np.tile(np.array([0, 1, 3.9], np.float32), (n, 1))
    rd = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    rd[:, 2] = -1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmin = jnp.full(n, RAY_EPS)
    tmax = jnp.full(n, 3.4e38)

    bh, bp, bu, bv, bt = intersect_bruteforce(
        jnp.asarray(sorted_prims), jnp.asarray(ro), jnp.asarray(rd), tmin, tmax
    )[:5]
    if tree.root_is_leaf:
        return  # tiny scene: brute force is the production path anyway
    th, tp, tu, tv, tt = intersect_bvh(
        jnp.asarray(tree.nodes), jnp.asarray(sorted_prims),
        jnp.asarray(ro), jnp.asarray(rd), tmin, tmax,
    )[:5]
    np.testing.assert_array_equal(np.asarray(bh), np.asarray(th))
    hits = np.asarray(bh)
    assert hits.mean() > 0.9  # narrow fan into the box: nearly all hit
    np.testing.assert_allclose(np.asarray(bt)[hits], np.asarray(tt)[hits], rtol=1e-5)


def test_bvh_large_instanced(rng):
    """~30k world prims from 5 rotated instances of two tessellated shapes."""
    from julia_raytracer.scene.generate import _displaced_shape, _rotation
    from julia_raytracer.scene.types import InstanceData, SceneData, ShapeData

    shapes = []
    for n in (8000, 4000):
        p, t, _, _ = _displaced_shape(rng, n)
        shapes.append(ShapeData(positions=p, triangles=t))
    instances = [
        InstanceData(frame=np.concatenate([_rotation(rng) * 1.5, [[3.0 * i - 6, 0, 0]]])
                     .astype(np.float32), shape=i % 2, material=0)
        for i in range(5)]
    flat = flatten_scene(SceneData(shapes=shapes, instances=instances))
    prims = flat.geometry.prim_verts
    assert len(prims) > 25_000
    tree = bvh_mod.build_bvh(*bvh_mod.quad_bounds(prims))
    sorted_prims = jnp.asarray(prims[tree.order])

    rng = np.random.default_rng(11)
    n = 128
    ro, rd = random_rays(rng, n)
    # aim at the scene bbox center
    center = prims.reshape(-1, 3).mean(axis=0)
    ro = jnp.asarray(
        center + np.array([0, 0, 30], np.float32) + rng.normal(size=(n, 3)).astype(np.float32)
    )
    rd = jnp.asarray(center) - ro + 2.0 * jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    rd = rd / jnp.linalg.norm(rd, axis=1, keepdims=True)
    tmin = jnp.full(n, RAY_EPS)
    tmax = jnp.full(n, 3.4e38)

    bh, bp, _, _, bt = intersect_bruteforce(sorted_prims, ro, rd, tmin, tmax)[:5]
    th, tp, _, _, tt = intersect_bvh(
        jnp.asarray(tree.nodes), sorted_prims, ro, rd, tmin, tmax
    )[:5]
    np.testing.assert_array_equal(np.asarray(bh), np.asarray(th))
    hits = np.asarray(bh)
    np.testing.assert_allclose(np.asarray(bt)[hits], np.asarray(tt)[hits], rtol=1e-5)


def test_sah_bvh_vs_bruteforce(rng):
    """--highqualitybvh SAH build produces a correct tree."""
    prims = random_tri_soup(rng, 1200)
    tree = bvh_mod.build_bvh(*bvh_mod.quad_bounds(prims), sah=True)
    assert not tree.root_is_leaf
    assert sorted(tree.order.tolist()) == list(range(1200))  # permutation
    sorted_prims = prims[tree.order]

    ro, rd = random_rays(rng, 192)
    tmin = jnp.full(192, RAY_EPS)
    tmax = jnp.full(192, 3.4e38)
    bh, bp, _, _, bt = intersect_bruteforce(
        jnp.asarray(sorted_prims), ro, rd, tmin, tmax
    )[:5]
    th, tp, _, _, tt = intersect_bvh(
        jnp.asarray(tree.nodes), jnp.asarray(sorted_prims), ro, rd, tmin, tmax
    )[:5]
    np.testing.assert_array_equal(np.asarray(bh), np.asarray(th))
    hits = np.asarray(bh)
    np.testing.assert_allclose(np.asarray(bt)[hits], np.asarray(tt)[hits], rtol=1e-5)

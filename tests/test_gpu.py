"""Checks that only mean something on the card (marker `gpu`).

They skip on the CPU; `chip_smoke.py` runs them on a GPU. The precision
check guards the elementwise geometric products: a float32 product that
ran in TF32 would be off by ~1e-3 relative. The kernel checks compile the
intersectors for the card and compare them with the plain reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.ops import bvh as bvh_mod
from julia_raytracer.ops.geometry import RAY_EPS
from julia_raytracer.ops.traversal import intersect_bruteforce, intersect_bvh
from julia_raytracer.utils.vecmath import transform_point

pytestmark = pytest.mark.gpu


def test_transform_point_full_float32(gpu, rng):
    frames = rng.normal(size=(4096, 4, 3)).astype(np.float32)
    pts = rng.normal(size=(4096, 3)).astype(np.float32)
    got = jax.jit(transform_point)(jnp.asarray(frames), jnp.asarray(pts))
    assert got.devices() == {gpu}
    f64 = frames.astype(np.float64)
    want = np.einsum("nij,ni->nj", f64[:, :3], pts.astype(np.float64)) + f64[:, 3]
    assert np.abs(np.asarray(got) - want).max() / np.abs(want).max() < 1e-5


def test_bvh_matches_bruteforce_on_card(gpu, rng):
    n_prims, n_rays = 5000, 8192
    base = rng.uniform(-1, 1, (n_prims, 3)).astype(np.float32)
    e1 = rng.uniform(-0.1, 0.1, (n_prims, 3)).astype(np.float32)
    e2 = rng.uniform(-0.1, 0.1, (n_prims, 3)).astype(np.float32)
    prims = np.stack([base, base + e1, base + e2, base + e2], axis=1)
    tree = bvh_mod.build_bvh(*bvh_mod.quad_bounds(prims))
    pv = jnp.asarray(prims[tree.order])
    ro = jnp.asarray(rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32))
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=1, keepdims=True))
    tmin, tmax = jnp.full(n_rays, RAY_EPS), jnp.full(n_rays, 3.4e38)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(intersect_bruteforce)(pv, ro, rd, tmin, tmax)
    got = jax.jit(intersect_bvh)(jnp.asarray(tree.nodes), pv, ro, rd, tmin, tmax)
    assert got.hit.devices() == {gpu}
    hits = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(got.hit), hits)
    assert hits.sum() > 1000
    np.testing.assert_allclose(np.asarray(got.t)[hits], np.asarray(ref.t)[hits], rtol=1e-5)
    same = np.asarray(got.prim)[hits] == np.asarray(ref.prim)[hits]
    assert same.mean() > 0.999


def test_dense_kernel_matches_bruteforce_on_card(gpu, rng):
    """The compiled Triton kernel picks the same prims as XLA's argmin,
    on a ray count that is not a multiple of its block."""
    from julia_raytracer.ops.triton_intersect import BLOCK, intersect_dense

    n_prims, n_rays = 300, 40 * BLOCK + 17
    base = rng.uniform(-1, 1, (n_prims, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n_prims, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n_prims, 3)).astype(np.float32)
    pv = jnp.asarray(np.stack([base, base + e1, base + e1 + e2, base + e2], axis=1))
    ro = jnp.asarray(rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32))
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=1, keepdims=True))
    tmin, tmax = jnp.full(n_rays, RAY_EPS), jnp.full(n_rays, 3.4e38)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(intersect_bruteforce)(pv, ro, rd, tmin, tmax)
    got = jax.jit(intersect_dense)(pv, ro, rd, tmin, tmax)
    hits = np.asarray(ref.hit)
    assert hits.sum() > 1000
    np.testing.assert_array_equal(np.asarray(got.hit), hits)
    np.testing.assert_array_equal(np.asarray(got.prim)[hits], np.asarray(ref.prim)[hits])
    np.testing.assert_allclose(np.asarray(got.t)[hits], np.asarray(ref.t)[hits], rtol=1e-5)

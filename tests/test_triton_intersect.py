"""The dense closest-hit kernel (ops/triton_intersect.py) in interpret
mode against `intersect_bruteforce`, its padding of the ray axis to the
block size, the prim table layout, the XLA prim choice used off the GPU,
and gradients through the recomputed hit record."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.ops.geometry import RAY_EPS
from julia_raytracer.ops.traversal import intersect_bruteforce
from julia_raytracer.ops.triton_intersect import (
    BLOCK, bruteforce_prim, intersect_dense, prim_table, triton_prim,
)


def _scene(seed, n_prims, n_rays):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (n_prims, 3)).astype(np.float32)
    e1 = rng.uniform(-0.5, 0.5, (n_prims, 3)).astype(np.float32)
    e2 = rng.uniform(-0.5, 0.5, (n_prims, 3)).astype(np.float32)
    pv = np.stack([base, base + e1, base + e1 + e2 * 1.1, base + e2], axis=1)
    tri = rng.random(n_prims) < 0.5  # half the prims are triangles (c == d)
    pv[tri, 2] = pv[tri, 3]
    ro = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    rd = rng.normal(size=(n_rays, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    tmax = np.where(np.arange(n_rays) % 5 == 0, 0.7, 3.4e38).astype(np.float32)
    return (jnp.asarray(pv), jnp.asarray(ro), jnp.asarray(rd),
            jnp.full(n_rays, RAY_EPS), jnp.asarray(tmax))


@pytest.mark.parametrize("n_prims", [1, 36, 112])
@pytest.mark.parametrize("n_rays", [1, BLOCK - 1, BLOCK + 1, 700])
def test_kernel_matches_bruteforce(n_prims, n_rays):
    pv, ro, rd, tmin, tmax = _scene(n_prims * 1000 + n_rays, n_prims, n_rays)
    inst = jnp.arange(n_prims, dtype=jnp.int32) * 3 + 1
    ref = intersect_bruteforce(pv, ro, rd, tmin, tmax, prim_instance=inst)
    got = intersect_dense(pv, ro, rd, tmin, tmax, prim_instance=inst, interpret=True)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(got.hit), hit)
    np.testing.assert_array_equal(np.asarray(got.prim)[hit], np.asarray(ref.prim)[hit])
    np.testing.assert_array_equal(np.asarray(got.instance)[hit],
                                  np.asarray(ref.instance)[hit])
    for f in ("t", "u", "v", "position", "gnormal"):
        np.testing.assert_allclose(np.asarray(getattr(got, f))[hit],
                                   np.asarray(getattr(ref, f))[hit],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    # misses report t = F32_MAX, as intersect_bruteforce does
    np.testing.assert_array_equal(np.asarray(got.t)[~hit], np.asarray(ref.t)[~hit])


def test_xla_prim_choice_matches_kernel():
    pv, ro, rd, tmin, tmax = _scene(3, 50, 600)
    a = np.asarray(bruteforce_prim(pv, ro, rd, tmin, tmax))
    b = np.asarray(triton_prim(pv, ro, rd, tmin, tmax, interpret=True))
    np.testing.assert_array_equal(a, b)
    assert (a == -1).any() and (a >= 0).any()


def test_platform_choice_off_gpu_is_the_plain_argmin():
    """On the CPU backend intersect_dense lowers bruteforce_prim."""
    pv, ro, rd, tmin, tmax = _scene(4, 40, 300)
    ref = intersect_bruteforce(pv, ro, rd, tmin, tmax)
    got = jax.jit(intersect_dense)(pv, ro, rd, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(got.prim)[hit], np.asarray(ref.prim)[hit])


def test_prim_table_layout():
    pv = jnp.arange(5 * 12, dtype=jnp.float32).reshape(5, 4, 3)
    tab = np.asarray(prim_table(pv))
    assert tab.shape == (16, 16)  # 12 coords + 4 pad rows, prims padded to 16
    np.testing.assert_array_equal(tab[:12, :5], np.asarray(pv).reshape(5, 12).T)
    assert (tab[12:] == 0).all() and (tab[:, 5:] == 0).all()
    assert prim_table(jnp.zeros((112, 4, 3))).shape == (16, 128)


def test_gradient_through_recomputed_hit():
    """d t / d ray origin through intersect_dense equals the brute-force
    one: the kernel only picks the prim, the hit is recomputed in JAX."""
    pv, ro, rd, tmin, tmax = _scene(5, 30, 256)
    hit = np.asarray(intersect_bruteforce(pv, ro, rd, tmin, tmax).hit)

    def total_t(fn, o):
        h = fn(pv, o, rd, tmin, tmax)
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    g_ref = jax.grad(lambda o: total_t(intersect_bruteforce, o))(ro)
    g_got = jax.grad(lambda o: total_t(
        lambda *a: intersect_dense(*a, interpret=True), o))(ro)
    np.testing.assert_allclose(np.asarray(g_got)[hit], np.asarray(g_ref)[hit],
                               rtol=1e-4, atol=1e-5)

"""A/B timings that decide the intersector and compaction defaults.

Runs on one GPU, in one process, and prints one line per measurement:

1. dense prim choice: what XLA makes of `intersect_bruteforce`'s argmin
   over [rays x prims] (`triton_intersect.bruteforce_prim`) against the
   Pallas/Triton kernel (`triton_prim`), 262,144 camera rays of the
   generated cornellbox (36 prims) and of a 112-prim scene;
2. the dense test (`intersect_dense`, Triton kernel) against the lockstep
   BVH at 36 to 30k prims, 262,144 coherent (camera-like) and incoherent
   (random) rays: the BRUTEFORCE_THRESHOLD table;
3. end to end, the flagship (cornellbox, 512 px, path, 8 bounces) in
   ms/sample, each pair timed A, B, B, A: the XLA dense test against the
   Triton kernel, and the plain loop against the gather compaction
   boundary.

Usage: python tools/intersector_ab.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def _timed(fn, *args, reps=10):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _soup(rng, n):
    base = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    s = 0.6 * n ** (-1 / 3)  # keep the soup's depth complexity ~constant
    e1 = rng.uniform(-s, s, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-s, s, (n, 3)).astype(np.float32)
    return np.stack([base, base + e1, base + e2, base + e2], axis=1)


def _rays(rng, n):
    ro = np.tile(np.array([0.0, 0.0, 4.0], np.float32), (n, 1))
    rd = rng.normal(size=(n, 3)).astype(np.float32) * 0.25
    rd[:, 2] = -1.0
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return jnp.asarray(ro), jnp.asarray(rd)


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, found {dev.platform}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; device_kind {dev.device_kind}", flush=True)

    from julia_raytracer.cli import enable_compile_cache
    from julia_raytracer.ops import bvh as bvh_mod
    from julia_raytracer.ops.camera import sample_camera
    from julia_raytracer.ops.geometry import F32_MAX, RAY_EPS
    from julia_raytracer.ops.traversal import intersect_bruteforce, intersect_bvh
    from julia_raytracer.ops.triton_intersect import (
        bruteforce_prim, intersect_dense, triton_prim,
    )
    from julia_raytracer.render import integrator
    from julia_raytracer.render.renderer import Params, Renderer, make_trace_state
    from julia_raytracer.scene.generate import ensure_scene
    from julia_raytracer.scene.loader import load_scene
    from julia_raytracer.utils import rng as rng_mod

    enable_compile_cache()
    rng = np.random.default_rng(0)
    path = ensure_scene("cornellbox")
    scene = load_scene(path)

    # -- 1. dense prim choice, kernel level
    r = Renderer(scene, Params(scene=path, resolution=512, samples=1))
    n = 512 * 512
    pix = jnp.arange(n, dtype=jnp.int32)
    st = rng_mod.seed_state(pix, jnp.int32(0), 0)
    puv, st = rng_mod.rand2f(st)
    luv, st = rng_mod.rand2f(st)
    ij = jnp.stack([pix % 512, pix // 512], axis=-1)
    ro, rd = sample_camera(r.cam_arrays, ij, (512, 512), puv, luv, False)
    tmin, tmax = jnp.full(n, RAY_EPS), jnp.full(n, F32_MAX)
    xla_p = jax.jit(bruteforce_prim)
    tri_p = jax.jit(triton_prim)
    soup112 = jnp.asarray(np.concatenate(
        [np.asarray(r.dscene.prim_verts),
         _soup(rng, 76) * np.float32(0.3) + np.array([0, 1, 0], np.float32)]))
    for label, pv in (("cornellbox 36 prims", r.dscene.prim_verts),
                      ("112 prims", soup112)):
        ta = _timed(xla_p, pv, ro, rd, tmin, tmax)
        tb = _timed(tri_p, pv, ro, rd, tmin, tmax)
        mis = int(np.sum(np.asarray(xla_p(pv, ro, rd, tmin, tmax))
                         != np.asarray(tri_p(pv, ro, rd, tmin, tmax))))
        print(f"dense prim choice {label}, {n} rays: xla {ta * 1e3:.4f} ms, "
              f"triton {tb * 1e3:.4f} ms, prim mismatches {mis}", flush=True)

    # -- 2. dense (Triton) vs BVH by prim count
    nr = 262144
    dense = jax.jit(intersect_dense)
    walk = jax.jit(intersect_bvh)
    for q in (36, 112, 1000, 4000, 10000, 30000):
        pv = _soup(rng, q)
        tree = bvh_mod.build_bvh(*bvh_mod.quad_bounds(pv))
        pvs = jnp.asarray(pv[tree.order])
        nodes = jnp.asarray(tree.nodes)
        t0_, t1_ = jnp.full(nr, RAY_EPS), jnp.full(nr, F32_MAX)
        for kind in ("coherent", "incoherent"):
            if kind == "coherent":
                a, b = _rays(rng, nr)
            else:
                a = jnp.asarray(rng.uniform(-1, 1, (nr, 3)).astype(np.float32))
                b = rng.normal(size=(nr, 3)).astype(np.float32)
                b = jnp.asarray(b / np.linalg.norm(b, axis=1, keepdims=True))
            td = _timed(dense, pvs, a, b, t0_, t1_, reps=5)
            tv = (float("nan") if tree.root_is_leaf
                  else _timed(walk, nodes, pvs, a, b, t0_, t1_, reps=5))
            print(f"threshold {q} prims, {nr} {kind} rays: dense "
                  f"{td * 1e3:.4f} ms, bvh {tv * 1e3:.4f} ms", flush=True)

    # -- 3. end to end, flagship ms/sample
    spp = 32

    def flagship(label, isec, compact):
        old = integrator.make_intersect
        integrator.make_intersect = isec
        try:
            p = Params(scene=path, resolution=512, samples=2 * spp, batch=spp,
                       bounces=8, sampler="path")
            rr = Renderer(scene, p)
            rr.options = rr.options._replace(compact=compact)
            s = make_trace_state(scene, p)
            s = rr.trace_samples(s)  # warm: compiles the timed kernel
            jax.block_until_ready(s.image)
            t0 = time.perf_counter()
            s = rr.trace_samples(s)
            jax.block_until_ready(s.image)
            dt = time.perf_counter() - t0
        finally:
            integrator.make_intersect = old
        print(f"flagship {label}: {dt / spp * 1e3:.4f} ms/sample", flush=True)

    def xla_isec(dscene, config):
        def isec(a, b, c, d):
            return intersect_bruteforce(dscene.prim_verts, a, b, c, d,
                                        prim_instance=dscene.prim_instance)
        return integrator.curve_wrap(isec, dscene, config)

    triton_isec = integrator.make_intersect
    for label, isec in (("xla-dense compact=off", xla_isec),
                        ("triton compact=off", triton_isec),
                        ("triton compact=off", triton_isec),
                        ("xla-dense compact=off", xla_isec)):
        flagship(label, isec, False)
    for compact in (False, True, True, False):
        flagship(f"triton compact={'on' if compact else 'off'}", triton_isec,
                 compact)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

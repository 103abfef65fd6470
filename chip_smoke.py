"""Bring-up check of the path tracer on NVIDIA GPUs, in one process.

    python chip_smoke.py               # one card: phases below
    python chip_smoke.py --devices 4   # four cards: the sharded phases only

One card:
  device     platform, device kind, JAX version, card name and power limit
  flagship   generated cornellbox, 512 px, path, 8 bounces, 32 spp through
             Renderer -> make_trace_state -> trace_samples -> get_image,
             then `cli.main` at 1280 px, 8 bounces, clamp 10, 4 spp
  heavy      generated kitchen_class, 1280x720, path, 8 bounces, 4 spp, and
             one profiled sample: share of device time in the BVH walk
  reference  the chosen intersector against `intersect_bruteforce` (primary
             and bounce rays), and a 128 px render against the CPU backend
  diff       one value_and_grad of `render/diff.make_param_loss`
  tests      the `gpu`-marked tests (pytest.main in this process)
Four cards (`--devices 4`):
  sharded    shard_render_fn and distributed_render_fn at 1024 px against
             single-card trace_wavefront, and one shard_train_step

Each phase prints its lines and wall time. The last line is one JSON
object, printed only when every phase passed; without a GPU, or without
the rest of the repository beside it, the script exits non-zero before
printing any result. The CLI image goes to out/chip_smoke/.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "out", "chip_smoke")


class PhaseError(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_name_and_power() -> str:
    """nvidia-smi in a child process that does not touch JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def peak_bytes(dev) -> int:
    return int(dev.memory_stats()["peak_bytes_in_use"])


def camera_rays(r, width, height, pixels, seed=0):
    import jax.numpy as jnp

    from julia_raytracer.ops.camera import sample_camera
    from julia_raytracer.utils import rng as rng_mod

    pix = jnp.asarray(pixels, jnp.int32)
    st = rng_mod.seed_state(pix, jnp.int32(0), seed)
    puv, st = rng_mod.rand2f(st)
    luv, st = rng_mod.rand2f(st)
    ij = jnp.stack([pix % width, pix // width], axis=-1)
    ro, rd = sample_camera(r.cam_arrays, ij, (width, height), puv, luv, False)
    return ro, rd, st


# ---------------------------------------------------------------------------
# one-card phases


def phase_flagship(ctx):
    import jax
    import numpy as np

    from julia_raytracer import cli
    from julia_raytracer.render.renderer import Params, Renderer, make_trace_state
    from julia_raytracer.scene.generate import ensure_scene
    from julia_raytracer.scene.loader import load_scene
    from julia_raytracer.utils.imgio import load_png_rgba

    path = ensure_scene("cornellbox")
    scene = load_scene(path)
    spp = 32
    params = Params(scene=path, resolution=512, samples=2 * spp, batch=spp,
                    bounces=8, sampler="path")
    r = Renderer(scene, params)
    state = make_trace_state(scene, params)
    t0 = time.perf_counter()
    state = r.trace_samples(state)  # warms the timed kernel
    jax.block_until_ready(state.image)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = r.trace_samples(state)
    jax.block_until_ready(state.image)
    dt = time.perf_counter() - t0
    img = r.get_image(state)
    mpaths = state.n_pixels * spp / dt / 1e6
    print(f"flagship: cornellbox {state.width}x{state.height}, intersector "
          f"{r.intersector}, first {spp} spp incl. compile {first:.3f} s "
          f"(compile ~{first - dt:.3f} s), {dt / spp * 1e3:.4f} ms/sample, "
          f"{mpaths:.3f} Mpaths/s, peak_bytes_in_use {peak_bytes(ctx['dev'])}")
    check(np.isfinite(img).all(), "flagship image has non-finite pixels")
    check(img[..., :3].mean() > 0.01, "flagship image is black")
    ctx["cornell"] = (path, scene, r)

    out = os.path.join(OUT, "cornellbox_1280.png")
    t0 = time.perf_counter()
    rc = cli.main(["--scene", path, "--output", out, "--resolution", "1280",
                   "--samples", "4", "--batch", "4", "--bounces", "8",
                   "--clamp", "10", "--sampler", "path"])
    png = load_png_rgba(out)
    print(f"flagship: cli.main 1280 px 4 spp rc={rc} in "
          f"{time.perf_counter() - t0:.3f} s, png {png.shape}, mean "
          f"{png[..., :3].mean():.2f}")
    check(rc == 0 and png.shape == (1280, 1280, 4), "CLI render failed")
    check(png[..., :3].mean() > 2, "CLI image is black")


def phase_heavy(ctx):
    import jax
    import numpy as np

    from julia_raytracer.render.renderer import Params, Renderer, make_trace_state
    from julia_raytracer.scene.generate import ensure_scene
    from julia_raytracer.scene.loader import load_scene
    from julia_raytracer.utils.profile import device_time_by_scope, latest_xplane

    t0 = time.perf_counter()
    path = ensure_scene("kitchen_class")
    scene = load_scene(path)
    load_s = time.perf_counter() - t0
    spp = 4
    params = Params(scene=path, resolution=1280, samples=1 + spp + 1, batch=1,
                    bounces=8, sampler="path")
    t0 = time.perf_counter()
    r = Renderer(scene, params)
    jax.block_until_ready(r.dscene)
    setup_s = time.perf_counter() - t0
    state = make_trace_state(scene, params)
    t0 = time.perf_counter()
    state = r.trace_samples(state)
    jax.block_until_ready(state.image)
    first = time.perf_counter() - t0
    r.params.batch = spp
    t0 = time.perf_counter()
    state = r.trace_samples(state)
    jax.block_until_ready(state.image)
    dt = time.perf_counter() - t0
    n_prims = r.config.n_prims
    print(f"heavy: kitchen_class {state.width}x{state.height}, {n_prims} prims, "
          f"intersector {r.intersector}, generate+load {load_s:.3f} s, host "
          f"set-up (flatten+BVH+upload) {setup_s:.3f} s, first sample incl. "
          f"compile {first:.3f} s, {dt / spp * 1e3:.2f} ms/sample, "
          f"{state.n_pixels * spp / dt / 1e6:.3f} Mpaths/s, peak_bytes_in_use "
          f"{peak_bytes(ctx['dev'])}")
    ctx["kitchen"] = (path, scene, r)

    # the trace is parsed here and removed: it is too large to keep
    trace_dir = os.path.join(REPO, ".profile_tmp")
    shutil.rmtree(trace_dir, ignore_errors=True)
    r.params.batch = 1
    with jax.profiler.trace(trace_dir):
        state = r.trace_samples(state)
        jax.block_until_ready(state.image)
    img = r.get_image(state)
    check(np.isfinite(img).all(), "kitchen image has non-finite pixels")
    check(img[..., :3].mean() > 1e-3, "kitchen image is black")
    kernel = next(iter(r._kernel_cache.values()))
    hlo = kernel.lower(r.dscene, r.cam_arrays, state.image, state.albedo,
                       state.normal, state.hits, np.int32(0),
                       np.int32(0)).compile().as_text()
    t = device_time_by_scope(latest_xplane(trace_dir), hlo, ["bvh_traversal"])
    shutil.rmtree(trace_dir, ignore_errors=True)
    check(t["total"] > 0, f"no device events in the trace: {t}")
    share = t["bvh_traversal"] / t["total"]
    print(f"heavy: profiled sample, {t['events']} kernel events, device time "
          f"{t['total'] / 1e6:.2f} ms: BVH traversal {share:.4f}, shading and "
          f"the rest {1 - share:.4f}")
    for op, ns, scope in t["top"][:8]:
        print(f"heavy:   {op}: {ns / 1e6:.2f} ms ({scope})")


def _compare_hits(label, got, ref):
    import numpy as np

    hg, hr = np.asarray(got.hit), np.asarray(ref.hit)
    hit_mis = int((hg != hr).sum())
    both = hg & hr
    tg, tr = np.asarray(got.t)[both], np.asarray(ref.t)[both]
    rel = np.abs(tg - tr) / np.maximum(np.abs(tr), 1e-30)
    pdiff = np.asarray(got.prim)[both] != np.asarray(ref.prim)[both]
    ties = pdiff & (rel <= 1e-6)
    prim_mis = int((pdiff & ~ties).sum())
    t_bad = int((rel > 1e-5).sum())
    print(f"reference: {label}: {len(hg)} rays, {int(both.sum())} hits, hit "
          f"mismatches {hit_mis}, prim mismatches {prim_mis} (+{int(ties.sum())} "
          f"ties within 1e-6), max t rel diff {rel.max() if rel.size else 0:.3e}, "
          f"t beyond 1e-5: {t_bad}")
    return hit_mis == 0 and prim_mis == 0 and t_bad == 0


def _bounce_rays(hit, rd, seed):
    """Cosine-weighted directions about the hit's facing geometric normal."""
    import jax.numpy as jnp

    from julia_raytracer.ops.bsdf import sample_hemisphere_cos
    from julia_raytracer.utils import rng as rng_mod

    n = rd.shape[0]
    gn = jnp.where((jnp.sum(hit.gnormal * rd, -1) > 0)[:, None], -hit.gnormal,
                   hit.gnormal)
    st = rng_mod.seed_state(jnp.arange(n, dtype=jnp.int32), jnp.int32(1), seed)
    rn, _ = rng_mod.rand2f(st)
    d = sample_hemisphere_cos(gn, rn)
    return hit.position, d


def phase_reference(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from julia_raytracer.ops.geometry import F32_MAX, RAY_EPS
    from julia_raytracer.ops.traversal import intersect_bruteforce
    from julia_raytracer.render.integrator import make_intersect
    from julia_raytracer.render.renderer import Params, Renderer, make_trace_state

    ok = True

    def ref_bruteforce(pv, ro, rd, chunk):
        n = ro.shape[0]
        tmin, tmax = jnp.full(n, RAY_EPS), jnp.full(n, F32_MAX)
        with jax.default_matmul_precision("highest"):
            if chunk >= n:
                return jax.jit(intersect_bruteforce)(pv, ro, rd, tmin, tmax)
            c = lambda a: a.reshape((n // chunk, chunk) + a.shape[1:])
            h = jax.jit(lambda a, b, t0, t1: jax.lax.map(
                lambda x: intersect_bruteforce(pv, *x), (a, b, t0, t1)))(
                    c(ro), c(rd), c(tmin), c(tmax))
            return jax.tree.map(lambda a: a.reshape((n,) + a.shape[2:]), h)

    for name, chunk, n_rays in (("cornellbox", 1 << 30, None),
                                ("kitchen", 64, 8192)):
        _path, _scene, r = ctx["cornell" if name == "cornellbox" else "kitchen"]
        w, h = (512, 512) if name == "cornellbox" else (1280, 720)
        pixels = (np.arange(w * h) if n_rays is None else np.sort(
            np.random.default_rng(0).choice(w * h, n_rays, replace=False)))
        ro, rd, _ = camera_rays(r, w, h, pixels)
        isec = jax.jit(lambda ds, a, b: make_intersect(ds, r.config)(
            a, b, jnp.full(a.shape[0], RAY_EPS), jnp.full(a.shape[0], F32_MAX)))
        got = isec(r.dscene, ro, rd)
        ref = ref_bruteforce(r.dscene.prim_verts, ro, rd, chunk)
        ok &= _compare_hits(f"{name} primary ({r.intersector})", got, ref)
        bro, brd = _bounce_rays(ref, rd, 0)
        got = isec(r.dscene, bro, brd)
        ref = ref_bruteforce(r.dscene.prim_verts, bro, brd, chunk)
        ok &= _compare_hits(f"{name} bounce ({r.intersector})", got, ref)
    check(ok, "intersector disagrees with the brute-force reference")

    # image against the CPU backend of this process
    path, scene, _ = ctx["cornell"]

    def render_on(device, seed):
        with jax.default_device(device):
            p = Params(scene=path, resolution=128, samples=16, batch=16,
                       bounces=8, sampler="path", seed=seed)
            rr = Renderer(scene, p)
            st = rr.trace_samples(make_trace_state(scene, p))
            return rr.get_image(st)[..., :3]

    def block_means(img):
        return img.reshape(16, 8, 16, 8, 3).mean(axis=(1, 3))

    t0 = time.perf_counter()
    cpu = jax.devices("cpu")[0]
    g0 = block_means(render_on(ctx["dev"], 0))
    c0 = block_means(render_on(cpu, 0))
    c1 = block_means(render_on(cpu, 1))
    d_gc = float(np.abs(g0 - c0).max())
    noise = float(np.abs(c0 - c1).max())
    print(f"reference: cornellbox 128 px 16 spp, 8x8 block means: max |GPU - "
          f"CPU| (seed 0) {d_gc:.6f}, noise floor max |CPU seed 0 - CPU seed 1| "
          f"{noise:.6f}, tolerance = noise floor ({time.perf_counter() - t0:.1f} s)")
    check(d_gc <= noise, "GPU image differs from the CPU image beyond the noise floor")


def phase_diff(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from julia_raytracer.render.diff import diff_options, make_param_loss, render_radiance
    from julia_raytracer.render.renderer import Params, Renderer, make_trace_state

    path, scene, _ = ctx["cornell"]
    params = Params(scene=path, resolution=256, samples=1, bounces=8, sampler="path")
    r = Renderer(scene, params)
    st = make_trace_state(scene, params)
    w, h = st.width, st.height
    pix = jnp.arange(w * h, dtype=jnp.int32)
    rad = render_radiance(r.dscene, r.config, diff_options(r.options, r.config),
                          r.cam_arrays, w, h, pix, jnp.int32(0))
    target = 2.0 * rad
    loss = make_param_loss(r.dscene, r.config, r.options, r.cam_arrays, w, h)
    vg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)), static_argnums=(4,))
    mats = r.dscene.materials
    t0 = time.perf_counter()
    val, (g_color, g_emis) = vg(mats.color, mats.emission, pix, target, 1)
    jax.block_until_ready(g_emis)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    val, (g_color, g_emis) = vg(mats.color, mats.emission, pix, target, 1)
    jax.block_until_ready(g_emis)
    dt = time.perf_counter() - t0
    g_color, g_emis = np.asarray(g_color), np.asarray(g_emis)
    print(f"diff: cornellbox {w}x{h}, value_and_grad first call {first:.3f} s, "
          f"then {dt * 1e3:.2f} ms, loss {float(val):.6f}, light emission grad "
          f"sum {g_emis[4].sum():.6e}, peak_bytes_in_use {peak_bytes(ctx['dev'])}")
    check(np.isfinite(float(val)), "non-finite loss")
    check(np.isfinite(g_color).all() and np.isfinite(g_emis).all(), "non-finite grads")
    check(g_emis[4].sum() < 0, "light emission gradient does not point toward the target")


def phase_tests(ctx):
    import pytest

    os.environ["JRT_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    print(f"tests: pytest -m gpu exit code {int(rc)}")
    check(int(rc) == 0, "gpu-marked tests failed")


# ---------------------------------------------------------------------------
# four-card phase


def phase_sharded(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from julia_raytracer.parallel.distributed import distributed_render_fn, global_mesh
    from julia_raytracer.parallel.mesh import make_mesh, shard_render_fn, shard_train_step
    from julia_raytracer.render.integrator import trace_wavefront
    from julia_raytracer.render.renderer import Params, Renderer, make_trace_state
    from julia_raytracer.scene.generate import ensure_scene
    from julia_raytracer.scene.loader import load_scene
    from julia_raytracer.utils.profile import device_time_by_scope, latest_xplane
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_dev = ctx["n_devices"]
    path = ensure_scene("cornellbox")
    scene = load_scene(path)
    params = Params(scene=path, resolution=1024, samples=1, bounces=8, sampler="path")
    r = Renderer(scene, params)
    st = make_trace_state(scene, params)
    w, h = st.width, st.height
    rays = camera_rays(r, w, h, np.arange(w * h))

    def timed(fn, args):
        """(outputs, first call incl. compile s, second call s)"""
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        return out, first, time.perf_counter() - t0

    single = jax.jit(lambda ds, a, b, c: trace_wavefront(
        ds, r.config, r.options, a, b, c)[:4])
    (rad1, hit1, _, _), _, t_single = timed(single, (r.dscene, *rays))
    mesh = make_mesh(n_dev)
    # scene replicated and rays sharded before the timed calls, so they
    # time the render and not the transfer from card 0
    sh = lambda *spec: NamedSharding(mesh, P(*spec))
    args = (jax.device_put(r.dscene, sh()),
            jax.device_put(rays[0], sh("rays", None)),
            jax.device_put(rays[1], sh("rays", None)),
            jax.device_put(rays[2], sh("rays")))
    for label, fn in (("shard_render_fn", shard_render_fn(mesh, r.dscene, r.config, r.options)),
                      ("distributed_render_fn", distributed_render_fn(
                          global_mesh(), r.dscene, r.config, r.options))):
        (rad, hit, _, _), first, dt = timed(fn, args)
        hit_mis = int((np.asarray(hit) != np.asarray(hit1)).sum())
        rad, rad_1 = np.asarray(rad), np.asarray(rad1)
        close = np.isclose(rad, rad_1, rtol=5e-4, atol=1e-6)
        print(f"sharded: {label} {w}x{h} 1 spp on {n_dev} cards: first call "
              f"{first:.3f} s, then {dt * 1e3:.2f} ms (one card "
              f"{t_single * 1e3:.2f} ms, scaling efficiency "
              f"{t_single / (n_dev * dt):.3f}): hit mismatches {hit_mis}, "
              f"radiance lanes outside rtol 5e-4 {int((~close).any(-1).sum())}, "
              f"max abs diff {np.abs(rad - rad_1).max():.3e}")
        check(hit_mis == 0 and close.all(), f"{label} differs from one card")

    # kernel time per card in one traced sharded call, against its wall
    trace_dir = os.path.join(REPO, ".profile_tmp")
    shutil.rmtree(trace_dir, ignore_errors=True)
    with jax.profiler.trace(trace_dir):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        wall = time.perf_counter() - t0
    busy = [device_time_by_scope(latest_xplane(trace_dir), "", [],
                                 plane_prefix=f"/device:GPU:{i}")["total"]
            for i in range(n_dev)]
    shutil.rmtree(trace_dir, ignore_errors=True)
    print(f"sharded: traced {label} call, wall {wall * 1e3:.2f} ms, kernel "
          f"time per card (ms): {', '.join(f'{b / 1e6:.2f}' for b in busy)}")

    res = 512
    p2 = Params(scene=path, resolution=res, samples=1, bounces=8, sampler="path")
    r2 = Renderer(scene, p2)
    n = res * res
    step = shard_train_step(mesh, r2.dscene, r2.config, r2.options, r2.cam_arrays,
                            res, res)
    mats = r2.dscene.materials
    t0 = time.perf_counter()
    loss, new_color, new_emis = step(mats.color, mats.emission,
                                     jnp.arange(n, dtype=jnp.int32),
                                     jnp.zeros((n, 3), jnp.float32), 1)
    loss = float(jax.block_until_ready(loss))
    moved = float(np.abs(np.asarray(new_emis) - np.asarray(mats.emission)).max())
    print(f"sharded: shard_train_step {res}x{res} on {n_dev} cards in "
          f"{time.perf_counter() - t0:.3f} s: loss {loss:.6f}, max emission "
          f"change {moved:.3e}")
    check(np.isfinite(loss) and np.isfinite(np.asarray(new_color)).all(),
          "non-finite train step")
    check(moved > 0, "emission did not move")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="path tracer bring-up check on GPUs")
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded phases over four cards")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found platform {dev.platform!r}",
              file=sys.stderr)
        return 1
    if len(devs) < args.devices:
        print(f"chip_smoke: --devices {args.devices} needs {args.devices} "
              f"cards, found {len(devs)}", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from julia_raytracer.cli import enable_compile_cache

    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    card = card_name_and_power()
    print(f"device: platform {dev.platform}, kind {dev.device_kind}, count "
          f"{len(devs)}, jax {jax.__version__}")
    print(f"device: card (name, power limit) {card}")

    ctx = {"dev": dev, "n_devices": args.devices}
    phases = ([phase_sharded] if args.devices == 4 else
              [phase_flagship, phase_heavy, phase_reference, phase_diff, phase_tests])
    failed = []
    for phase in phases:
        name = phase.__name__[len("phase_"):]
        t0 = time.perf_counter()
        try:
            phase(ctx)
        except Exception:  # report, run the remaining phases, then fail
            traceback.print_exc()
            failed.append(name)
            print(f"phase {name}: FAILED", flush=True)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"total: {time.perf_counter() - t_start:.1f} s; card {card}")
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

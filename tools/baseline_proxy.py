"""Measured-proxy baseline denominator (VERDICT r4 item 9).

The reference publishes no perf numbers and Julia is not installed, so
"matching-or-beating" needs a constructible bound. This tool measures
THIS repo's integrator on the XLA-CPU backend pinned to ONE core
(cornellbox 512 px, path, 8 bounces — the bench.py protocol) and scales
by a generous thread count to stand in for the reference's rate:

- same algorithm (the integrator is a line-by-line parity port of
  src/trace.jl:276-469), same scene, same spp accounting;
- XLA-CPU runs the wavefront VECTORIZED (SIMD over 262k-lane batches),
  which a scalar per-ray Julia tracer does not — so per-core this proxy
  is, if anything, GENEROUS to the reference;
- the reference report names no hardware or thread count
  (report/project_report.tex mentions threads only structurally), so the
  proxy assumes 32 hardware threads — a high-end workstation, above any
  plausible student-laptop figure.

Usage:
  python tools/baseline_proxy.py --warm     # populate compile cache (unpinned)
  taskset -c 0 python tools/baseline_proxy.py --measure --json BASELINE_PROXY.json
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

ASSUMED_REFERENCE_THREADS = 32
RESOLUTION = 512
WARM_SPP = 1
BENCH_SPP = 8


def run(measure: bool):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from julia_raytracer.cli import enable_compile_cache
    from julia_raytracer.render.renderer import (
        Params, Renderer, make_trace_state,
    )
    from julia_raytracer.scene.generate import ensure_scene
    from julia_raytracer.scene.loader import load_scene

    enable_compile_cache()
    scene = load_scene(ensure_scene("cornellbox"))
    params = Params(
        resolution=RESOLUTION, samples=WARM_SPP + BENCH_SPP, bounces=8,
        sampler="path", batch=WARM_SPP,
    )
    r = Renderer(scene, params)
    state = make_trace_state(scene, params)
    t0 = time.perf_counter()
    state = r.trace_samples(state)
    jax.block_until_ready(state.image)
    warm_s = time.perf_counter() - t0
    print(f"warm ({WARM_SPP} spp incl. compile): {warm_s:.1f}s", flush=True)

    r.params.batch = BENCH_SPP
    t0 = time.perf_counter()
    state = r.trace_samples(state)
    jax.block_until_ready(state.image)
    dt = time.perf_counter() - t0
    mpaths = state.n_pixels * BENCH_SPP / dt / 1e6
    print(f"bench: {BENCH_SPP} spp in {dt:.1f}s = {mpaths:.4f} Mpaths/s",
          flush=True)
    return mpaths, dt


def main():
    if "--warm" in sys.argv:
        run(measure=False)
        return
    try:
        affinity = sorted(os.sched_getaffinity(0))
    except AttributeError:
        affinity = []
    if "--measure" in sys.argv and len(affinity) != 1:
        raise SystemExit(
            f"--measure must run pinned to ONE core (taskset -c 0); "
            f"affinity is {affinity}"
        )
    mpaths, dt = run(measure=True)
    payload = {
        "core_mpaths": round(mpaths, 4),
        "bench_seconds": round(dt, 1),
        "resolution": RESOLUTION,
        "spp": BENCH_SPP,
        "affinity_cores": len(affinity) or None,
        "assumed_reference_threads": ASSUMED_REFERENCE_THREADS,
        "proxy_mpaths": round(mpaths * ASSUMED_REFERENCE_THREADS, 3),
        "method": (
            "this repo's integrator on XLA-CPU pinned to 1 core "
            "(same algorithm as src/trace.jl:276-469, vectorized — "
            "generous per-core), x assumed_reference_threads"
        ),
    }
    print(json.dumps(payload))
    if "--json" in sys.argv:
        out = sys.argv[sys.argv.index("--json") + 1]
        with open(out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()

"""Headline benchmark: cornellbox path tracing throughput (Mpaths/s).

Renders the generated cornellbox at 512 px, path sampler, 8 bounces:
32 samples to warm every compiled shape, then a timed window of 32
samples ending in `jax.block_until_ready`. Prints ONE JSON line naming
the device it ran on. Needs a GPU: on any other platform it exits
non-zero and prints no result.

vs_baseline: the reference publishes no throughput numbers
(BASELINE.md); the denominator is a measured CPU proxy
(tools/baseline_proxy.py -> BASELINE_PROXY.json: this repo's integrator
on XLA-CPU pinned to one core, times 32 assumed reference threads).
"""

from __future__ import annotations

import json
import os
import sys
import time


def _baseline() -> tuple[float, str]:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "BASELINE_PROXY.json")
    with open(path) as f:
        p = json.load(f)
    return float(p["proxy_mpaths"]), (
        f"{p['proxy_mpaths']} Mpaths/s = this repo's integrator on XLA-CPU "
        f"pinned to 1 core ({p['core_mpaths']} Mpaths/s) x "
        f"{p['assumed_reference_threads']} assumed reference threads "
        "(tools/baseline_proxy.py)")


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found platform {dev.platform!r}",
              file=sys.stderr)
        return 1
    from julia_raytracer.cli import enable_compile_cache
    from julia_raytracer.render.renderer import Params, Renderer, make_trace_state
    from julia_raytracer.scene.generate import ensure_scene
    from julia_raytracer.scene.loader import load_scene
    from julia_raytracer.utils.roofline import device_peaks

    enable_compile_cache()
    spp = 32
    path = ensure_scene("cornellbox")
    scene = load_scene(path)
    params = Params(scene=path, resolution=512, samples=2 * spp, batch=spp,
                    bounces=8, sampler="path")
    renderer = Renderer(scene, params)
    state = make_trace_state(scene, params)
    t0 = time.perf_counter()
    state = renderer.trace_samples(state)  # warm: compiles the timed kernel
    jax.block_until_ready(state.image)
    setup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state = renderer.trace_samples(state)
    jax.block_until_ready(state.image)
    dt = time.perf_counter() - t0

    mpaths = state.n_pixels * spp / dt / 1e6
    base, base_note = _baseline()
    print(json.dumps({
        "metric": "cornellbox_path_throughput",
        "value": mpaths,
        "unit": "Mpaths/s",
        "ms_per_sample": dt / spp * 1e3,
        "vs_baseline": mpaths / base,
        "baseline_note": base_note,
        "first_batch_incl_compile_s": setup_s,
        "peak_bytes_in_use": int(dev.memory_stats()["peak_bytes_in_use"]),
        # the roofline's denominators; its numerators need a device trace
        "device_peaks": device_peaks(dev.device_kind),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

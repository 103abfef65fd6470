"""Per-iteration alive-lane profile of the megakernel while_loop.

The bounce loop is one while_loop that runs EVERY lane until the LAST
survivor dies (unless trace_wavefront's survivor compaction narrows it).
This tool scans the same body with a per-iteration alive count
(trace_wavefront(alive_trace=True)) to size the wasted full-width
iterations: work_ratio = sum(alive_i)/(iters_live x n) is the ideal
compaction ceiling (1/work_ratio = max possible speedup from perfect
lane compaction at zero cost).

Run: python tools/alive_profile.py [generated scene name] [res]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    scene_name = args[0] if args else "cornellbox"
    res = int(args[1]) if len(args) > 1 else 512

    import jax
    import jax.numpy as jnp

    from julia_raytracer.cli import enable_compile_cache
    from julia_raytracer.ops.camera import sample_camera
    from julia_raytracer.render.integrator import trace_wavefront
    from julia_raytracer.render.renderer import (
        Params, Renderer, make_trace_state,
    )
    from julia_raytracer.scene.generate import ensure_scene
    from julia_raytracer.scene.loader import load_scene
    from julia_raytracer.utils import rng as rng_mod

    enable_compile_cache()
    scene_path = ensure_scene(scene_name)
    scene = load_scene(scene_path)
    params = Params(
        scene=scene_path, resolution=res, samples=1, bounces=8,
        sampler="path",
    )
    r = Renderer(scene, params)
    state = make_trace_state(scene, params)
    n = state.n_pixels
    pix = jnp.arange(n, dtype=jnp.int32)
    rng = rng_mod.seed_state(pix, jnp.int32(0), 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = jnp.stack([pix % state.width, pix // state.width], axis=-1)
    ro, rd = sample_camera(
        r.cam_arrays, ij, (state.width, state.height), puv, luv, False)

    f = jax.jit(lambda dscene, ro, rd, rng: trace_wavefront(
        dscene, r.config, r.options, ro, rd, rng,
        alive_trace=True,
    ))
    t0 = time.time()
    outs = f(r.dscene, ro, rd, rng)
    counts = np.asarray(outs[-1])
    print(f"(compile+run {time.time()-t0:.1f}s)  n={n}")
    live = counts[counts > 0]
    iters_live = len(live) + 1  # +1: the primary-intersect iteration
    frac = counts / n
    print("alive fraction per iteration:",
          [round(float(x), 4) for x in frac[: iters_live + 2]])
    work_ratio = (n + live.sum()) / (iters_live * n)
    print(json.dumps({
        "scene": scene_name, "res": res, "n": int(n),
        "iterations": int(iters_live),
        "work_ratio": round(float(work_ratio), 4),
        "ideal_compaction_speedup": round(float(1.0 / work_ratio), 3),
    }))


if __name__ == "__main__":
    main()

"""Inverse-rendering demo: recover cornellbox material albedos from a
target image by gradient descent through the differentiable renderer
(BASELINE config 3 exercised end-to-end; render/diff.py).

The target is a render with the scene's TRUE material colors; the
optimization starts from flat gray and recovers them through
`make_param_loss` (detached-sampling gradients) with optax Adam.

Usage: python tools/invrender_demo.py [--res 48] [--steps 40] [--spp 4]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=48)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax

    from julia_raytracer.render.diff import (
        diff_options, render_radiance_mean,
    )
    from julia_raytracer.cli import enable_compile_cache
    from julia_raytracer.render.renderer import Params, Renderer, make_trace_state
    from julia_raytracer.scene.generate import ensure_scene
    from julia_raytracer.scene.loader import load_scene

    enable_compile_cache()
    scene = load_scene(ensure_scene("cornellbox"))
    params = Params(
        scene="cornellbox", resolution=args.res, sampler="path", bounces=4
    )
    r = Renderer(scene, params)
    state = make_trace_state(scene, params)
    W, H = state.width, state.height
    pixel_ids = jnp.arange(W * H, dtype=jnp.int32)

    true_color = r.dscene.materials.color
    true_emission = r.dscene.materials.emission

    print(f"rendering target ({W}x{H}, {args.spp * 4} spp)...")
    target = render_radiance_mean(
        r.dscene, r.config, diff_options(r.options, r.config), r.cam_arrays,
        W, H, pixel_ids, args.spp * 4, seed=7,
    )
    target.block_until_ready()

    # Reinhard-tonemapped MSE: raw HDR MSE is dominated by refractive
    # caustic fireflies (MC variance), which drowns the albedo signal
    d_opts = diff_options(r.options, r.config)

    def tm(x):
        return x / (1.0 + x)

    def loss_fn(mat_color, mat_emission, pix, tgt, n_samples, seed=0):
        mats = r.dscene.materials._replace(
            color=mat_color, emission=mat_emission
        )
        d = r.dscene._replace(materials=mats)
        img = render_radiance_mean(
            d, r.config, d_opts, r.cam_arrays, W, H, pix, n_samples, seed
        )
        return jnp.mean((tm(img) - tm(tgt)) ** 2)
    sched = optax.cosine_decay_schedule(0.08, args.steps, alpha=0.05)
    opt = optax.adam(sched)
    color = jnp.full_like(true_color, 0.5)  # flat gray init
    opt_state = opt.init(color)

    @jax.jit
    def step(color, opt_state, seed):
        loss, g = jax.value_and_grad(loss_fn)(
            color, true_emission, pixel_ids, target, args.spp, seed
        )
        updates, opt_state = opt.update(g, opt_state)
        color = jnp.clip(optax.apply_updates(color, updates), 0.0, 1.0)
        return color, opt_state, loss

    # mean over materials that are actually visible (gradient reaches
    # them); emissives and off-screen materials keep ~zero gradient
    def mean_err(c):
        return float(jnp.abs(c - true_color).mean())

    err0 = mean_err(color)
    init_color = color
    def eval_loss(c):
        # matched-seed, higher-spp evaluation: the per-step loss sits on
        # the MC noise floor of args.spp samples and can't rank fits
        return float(
            loss_fn(c, true_emission, pixel_ids, target, args.spp * 4, 55)
        )
    loss0 = eval_loss(color)
    loss_true = eval_loss(true_color)  # MC noise floor of the eval
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        color, opt_state, loss = step(color, opt_state, 100 + i)
        losses.append(float(loss))
        if i % 10 == 0 or i == args.steps - 1:
            print(
                f"step {i:3d}  loss {float(loss):.5f}  "
                f"mean |color - true| {mean_err(color):.3f}"
            )
    dt = time.time() - t0
    err1 = mean_err(color)
    loss1 = eval_loss(color)
    rec = (loss0 - loss1) / max(loss0 - loss_true, 1e-9)
    print(
        f"{args.steps} steps in {dt:.1f}s; eval loss {loss0:.4f} -> "
        f"{loss1:.4f} (true-color noise floor {loss_true:.4f}; recovered "
        f"{100 * rec:.0f}% of the bridgeable gap); mean color error "
        f"{err0:.3f} -> {err1:.3f}"
    )
    # success = most of the bridgeable image-loss gap closed (the floor
    # is MC eval noise); some colors are unobservable at this resolution
    # (indirect-only coverage), so color error stays a diagnostic
    ok = rec > 0.5 and err1 < err0
    print("RECOVERED" if ok else "NOT CONVERGED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

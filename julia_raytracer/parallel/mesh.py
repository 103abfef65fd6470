"""Device-mesh sharding for rendering and differentiable training.

The reference's only parallelism is shared-memory threading over pixels
(src/trace.jl:253-254). Here: a 1-D `jax.sharding`
Mesh over the flat ray/pixel axis ("rays"); the scene (geometry, BVH,
textures, materials, light table) is replicated per device, pixel lanes
are sharded, and the forward pass needs ZERO cross-chip traffic. The
differentiable path all-reduces parameter gradients — emitted
automatically by XLA GSPMD from the sharding annotations (a psum that
XLA hands to NCCL), no hand-written collectives. The mesh is 1-D: the
cards of one host reach each other all to all over NVLink, so no device
order is better than another.

Scaling shape: rays/s is embarrassingly parallel in the ray axis, so the
design target is linear scaling until the per-device batch is too small
to fill the device (BASELINE config 5: >= 80% at N hosts).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from julia_raytracer.render.diff import make_param_loss
from julia_raytracer.render.integrator import trace_wavefront


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the ray axis. With n_devices=None, uses all devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("rays",))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def ray_sharded(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P("rays"))


def shard_render_fn(mesh: Mesh, dscene, config, options):
    """jit-compiled sharded forward: rays split over the mesh, scene
    replicated; returns (radiance, hit, albedo, normal) ray-sharded.

    Uses shard_map (not bare GSPMD annotations): the wavefront's
    between-bounce lane sort is an argsort over the ray axis, which
    GSPMD would implement as a global sort (an allgather + resort per
    bounce). Rays never need to communicate, so the sort must
    be PER-SHARD — shard_map runs the whole integrator per device on its
    local lanes, which is exactly that (and the counter-based RNG keys
    on pixel ids, so results are shard-layout invariant)."""
    from jax import shard_map

    rep, shard = replicated(mesh), ray_sharded(mesh)
    scene_sh = jax.tree.map(lambda _: rep, dscene)
    vec = NamedSharding(mesh, P("rays", None))

    def local_render(dscene, ro, rd, rng_state):
        radiance, hit, albedo, normal, _ = trace_wavefront(
            dscene, config, options, ro, rd, rng_state
        )
        return radiance, hit, albedo, normal

    render = shard_map(
        local_render,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(), dscene), P("rays", None),
                  P("rays", None), P("rays")),
        out_specs=(P("rays", None), P("rays"), P("rays", None), P("rays", None)),
        check_vma=False,
    )
    return jax.jit(
        render,
        in_shardings=(scene_sh, vec, vec, shard),
        out_shardings=(vec, shard, vec, vec),
    )


def shard_train_step(mesh: Mesh, dscene, config, options, cam, width, height,
                     lr: float = 0.05):
    """jit-compiled sharded training step over (material color, emission):
    pixel lanes sharded, parameters + scene replicated; the mean-loss
    gradient triggers an XLA-inserted psum across the mesh."""
    loss_fn = make_param_loss(dscene, config, options, cam, width, height)
    rep, shard = replicated(mesh), ray_sharded(mesh)
    scene_sh = jax.tree.map(lambda _: rep, dscene)
    vec = NamedSharding(mesh, P("rays", None))

    @partial(
        jax.jit,
        static_argnums=(4,),
        in_shardings=(rep, rep, shard, vec),
        out_shardings=(rep, rep, rep),
    )
    def step(mat_color, mat_emission, pixel_ids, target, n_samples):
        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            mat_color, mat_emission, pixel_ids, target, n_samples
        )
        new_color = mat_color - lr * grads[0]
        new_emission = mat_emission - lr * grads[1]
        return loss, new_color, new_emission

    return step

"""Worker process for the multi-host integration test.

Usage: python multihost_worker.py <coordinator> <num_procs> <process_id>
       <out_dir>

Connects to the jax.distributed coordinator on the CPU backend (4
virtual devices per process), renders one sample of cornellbox with
pixel lanes sharded over the global mesh, and writes the full gathered
radiance (host 0) plus this process's local shard to out_dir.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"),
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    coordinator, num_procs, pid, out_dir = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    )
    from julia_raytracer.parallel.distributed import (
        all_gather_image, broadcast_host_arrays, distributed_render_fn,
        global_mesh, init_distributed,
    )

    init_distributed(coordinator, num_procs, pid)
    assert jax.process_count() == num_procs
    mesh = global_mesh()
    n_dev = mesh.devices.size

    from julia_raytracer.ops.camera import sample_camera
    from julia_raytracer.render.integrator import TraceOptions
    from julia_raytracer.render.renderer import camera_arrays, image_size_for
    from julia_raytracer.render.scene_device import build_device_scene
    from julia_raytracer.scene.loader import find_camera, load_scene
    from julia_raytracer.utils import rng as rng_mod

    from julia_raytracer.scene.generate import ensure_scene

    scene = load_scene(ensure_scene("cornellbox"))
    dscene, config = build_device_scene(scene)
    # force bit-identical replicated tables from host 0
    dscene = broadcast_host_arrays(dscene)

    cam = scene.cameras[max(find_camera(scene, ""), 0)]
    ca = camera_arrays(cam)
    W, H = image_size_for(cam, 32)
    n = W * H
    per_dev = -(-n // n_dev)
    n_pad = per_dev * n_dev

    # per-lane quantities depend only on the pixel id -> each host
    # computes exactly its own slice, no host-side duplication
    ids = np.arange(n_pad, dtype=np.int32)
    ids[n:] = 0  # pad lanes render pixel 0; sliced off after gather
    local_ids = ids.reshape(num_procs, -1)[pid]
    lid = jnp.asarray(local_ids)
    rng = rng_mod.seed_state(lid, jnp.int32(0), 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = jnp.stack([lid % W, lid // W], axis=-1)
    ro, rd = sample_camera(ca, ij, (W, H), puv, luv, False)

    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    to_global = lambda x, spec: multihost_utils.host_local_array_to_global_array(
        np.asarray(x), mesh, spec
    )
    g_ro = to_global(ro, P("rays", None))
    g_rd = to_global(rd, P("rays", None))
    g_rng = jax.tree.map(lambda a: to_global(a, P("rays") if a.ndim == 1 else P("rays", None)), rng)

    options = TraceOptions(sampler="path", bounces=4)
    render = distributed_render_fn(mesh, dscene, config, options)
    radiance, hit, albedo, normal = render(dscene, g_ro, g_rd, g_rng)

    local = np.concatenate(
        [np.asarray(s.data) for s in radiance.addressable_shards], axis=0
    )
    np.save(os.path.join(out_dir, f"local_{pid}.npy"), local)
    full = all_gather_image(mesh, local).reshape(n_pad, 3)[:n]
    if pid == 0:
        np.save(os.path.join(out_dir, "full.npy"), full)
    print(f"worker {pid}: ok devices={n_dev}", flush=True)


if __name__ == "__main__":
    main()

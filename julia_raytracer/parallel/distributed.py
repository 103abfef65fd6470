"""Multi-host distribution: jax.distributed wiring + cross-host render.

The reference is a single-process shared-memory program (SURVEY §2:
no NCCL/MPI/any communication backend). Rendering across hosts
(BASELINE config 5):

- `jax.distributed.initialize` connects the processes; afterwards
  `jax.devices()` is the GLOBAL device list and a Mesh over it spans
  hosts. XLA hands the collectives GSPMD inserts to NCCL on GPUs (NVLink
  between the cards of a host, the network between hosts).
- The scene is REPLICATED: every host builds the same device tables from
  the same scene files; `broadcast_host_arrays` force-broadcasts host 0's
  tables so numerically-nondeterministic host builds can never diverge
  (the render itself needs zero cross-host traffic — rays don't
  communicate; only the differentiable mode all-reduces gradients).
- Pixels are sharded over the global ray axis: each process feeds its
  addressable shard via `make_array_from_process_local_data` and renders
  only its slice; `process_allgather` assembles the final image on every
  host (one gather per batch, overlapped with nothing because it IS the
  only cross-host traffic).

Tested by tests/test_multihost.py, which spawns two real OS processes on
the CPU backend (4 virtual devices each -> a 2-host x 4-device global
mesh) and checks the sharded render matches the single-process one.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Connect this process to the cluster. Arguments default from the
    standard env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID) so launchers can stay declarative. Without a cluster
    environment to detect, all three must be given."""
    kw = {}
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr:
        kw["coordinator_address"] = addr
    n = num_processes if num_processes is not None else os.environ.get("JAX_NUM_PROCESSES")
    if n is not None:
        kw["num_processes"] = int(n)
    pid = process_id if process_id is not None else os.environ.get("JAX_PROCESS_ID")
    if pid is not None:
        kw["process_id"] = int(pid)
    jax.distributed.initialize(**kw)


def global_mesh() -> Mesh:
    """1-D mesh over ALL devices of ALL processes (call after init)."""
    return Mesh(np.array(jax.devices()), axis_names=("rays",))


def broadcast_host_arrays(tree):
    """Replace every array in `tree` with host 0's copy, broadcast over
    the cluster — guarantees bit-identical replicated scene tables
    everywhere."""
    from jax.experimental import multihost_utils

    return multihost_utils.broadcast_one_to_all(tree)


def shard_pixels(mesh: Mesh, n_pixels: int) -> tuple[np.ndarray, jnp.ndarray]:
    """Split the padded global pixel index space across the mesh.

    Returns (local_pixel_ids [host-local numpy], global_pixel_array
    [jax.Array sharded over 'rays']). Padding lanes get id n_pixels (the
    render kernel masks ids >= n_pixels to weight 0)."""
    n_dev = mesh.devices.size
    per_dev = -(-n_pixels // n_dev)
    n_pad = per_dev * n_dev
    ids = np.arange(n_pad, dtype=np.int32)
    ids[n_pixels:] = n_pixels  # masked by the kernel
    from jax.experimental import multihost_utils

    garr = multihost_utils.host_local_array_to_global_array(
        ids.reshape(jax.process_count(), -1)[jax.process_index()],
        mesh,
        P("rays"),
    )
    local = ids.reshape(jax.process_count(), -1)[jax.process_index()]
    return local, garr


def all_gather_image(mesh: Mesh, local_image: np.ndarray) -> np.ndarray:
    """Concatenate per-process image slices to the full image on every
    host (one all-gather per batch)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(local_image))


def distributed_render_fn(mesh: Mesh, dscene, config, options):
    """Sharded radiance function over the global mesh: scene replicated,
    pixel lanes sharded. Identical math to the single-host path — the
    counter-based RNG keys on pixel ids, so the result is shard-layout
    invariant (tested single vs multi process)."""
    from jax import shard_map

    from julia_raytracer.render.integrator import trace_wavefront

    rep = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P("rays"))
    vec = NamedSharding(mesh, P("rays", None))
    scene_sh = jax.tree.map(lambda _: rep, dscene)

    def local_render(dscene_, ro, rd, rng_state):
        radiance, hit, albedo, normal, _ = trace_wavefront(
            dscene_, config, options, ro, rd, rng_state
        )
        return radiance, hit, albedo, normal

    # shard_map so the wavefront's between-bounce argsort stays PER
    # DEVICE (rays never communicate; a GSPMD global sort would
    # allgather every bounce — see parallel/mesh.py)
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

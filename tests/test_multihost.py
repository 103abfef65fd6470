"""Multi-host (multi-process) distribution test: two real OS processes
connected via jax.distributed on the CPU backend (4 virtual devices
each -> a 2x4 global mesh) must reproduce the single-process render
exactly. This validates the BASELINE config-5 code path — coordinator
wiring, cross-host mesh, scene broadcast over DCN, sharded pixel lanes,
image all-gather — without a cluster (SURVEY §5 distributed backend).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_render_matches_single(tmp_path):
    port = _free_port()
    coord = f"localhost:{port}"
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
    }
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", WORKER, coord, "2", str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"

    full = np.load(tmp_path / "full.npy")
    l0 = np.load(tmp_path / "local_0.npy")
    l1 = np.load(tmp_path / "local_1.npy")
    # shards partition the padded pixel space
    assert l0.shape[0] == l1.shape[0]
    n = full.shape[0]
    np.testing.assert_array_equal(
        np.concatenate([l0, l1], axis=0)[:n], full
    )

    # single-process reference on this process's own (8-device) mesh
    import jax.numpy as jnp
    from julia_raytracer.ops.camera import sample_camera
    from julia_raytracer.render.integrator import TraceOptions, trace_wavefront
    from julia_raytracer.render.renderer import camera_arrays, image_size_for
    from julia_raytracer.render.scene_device import build_device_scene
    from julia_raytracer.scene.loader import find_camera, load_scene
    from julia_raytracer.utils import rng as rng_mod

    from julia_raytracer.scene.generate import ensure_scene

    scene = load_scene(ensure_scene("cornellbox"))
    dscene, config = build_device_scene(scene)
    cam = scene.cameras[max(find_camera(scene, ""), 0)]
    ca = camera_arrays(cam)
    W, H = image_size_for(cam, 32)
    pix = jnp.arange(W * H, dtype=jnp.int32)
    rng = rng_mod.seed_state(pix, jnp.int32(0), 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = jnp.stack([pix % W, pix // W], axis=-1)
    ro, rd = sample_camera(ca, ij, (W, H), puv, luv, False)
    radiance, _, _, _, _ = trace_wavefront(
        dscene, config, TraceOptions(sampler="path", bounces=4), ro, rd, rng
    )
    # deterministic counter RNG keyed on pixel id -> multi-process result
    # must match the local render to float tolerance (different device
    # partitioning can fuse differently)
    np.testing.assert_allclose(full, np.asarray(radiance), atol=1e-5)

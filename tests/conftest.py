"""Test config: the CPU backend with 8 virtual devices.

`chip_smoke.py` runs the `gpu`-marked tests on a card in its own process
and sets JRT_TEST_PLATFORM=gpu first; then the backend is left alone.
Whether a card exists is decided inside the `gpu` fixture, never at
import or collection, so every xdist worker collects the same tests.
Must set env vars before jax is imported anywhere.
"""

import os

ON_GPU = os.environ.get("JRT_TEST_PLATFORM") == "gpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        )

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
# persistent compilation cache: XLA-CPU compiles of the traversal/integrator
# while-loops take minutes; cache them across test runs
os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", os.path.join(REPO, ".jax_cache"))
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from julia_raytracer.scene.generate import ensure_scene  # noqa: E402


@pytest.fixture(scope="session")
def scene_file():
    """scene name -> JSON path of the generated scene (seed 0)."""
    return ensure_scene


@pytest.fixture(scope="session")
def cornellbox():
    from julia_raytracer.scene.loader import load_scene

    return load_scene(ensure_scene("cornellbox"))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(7)


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform}); run by chip_smoke.py")
    return dev

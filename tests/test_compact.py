"""Survivor compaction in trace_wavefront (render/integrator.py).

Both boundaries must give the same image as the single while_loop:
dead lanes' outputs are final when they die, so moving the survivors to
a narrower buffer and merging the narrow results back changes nothing.
- unsorted wavefronts: argsort/gather narrowing, scatter merge;
- sorted wavefronts: the in-body liveness sort packs survivors into the
  prefix, so each boundary is a slice.
The width thresholds are lowered so a 32 x 32 frame crosses 1-3
boundaries.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.render import integrator


def _trace(cornellbox, sort_rays, compact):
    from julia_raytracer.ops.camera import sample_camera
    from julia_raytracer.render.renderer import Params, Renderer
    from julia_raytracer.utils import rng as rng_mod

    params = Params(resolution=32, samples=1, bounces=4, sampler="path")
    r = Renderer(cornellbox, params)
    n = 32 * 32
    pix = jnp.arange(n, dtype=jnp.int32)
    rng = rng_mod.seed_state(pix, jnp.int32(0), 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = jnp.stack([pix % 32, pix // 32], axis=-1)
    ro, rd = sample_camera(r.cam_arrays, ij, (32, 32), puv, luv, False)
    opts = r.options._replace(sort_rays=sort_rays, fixed_iterations=0,
                              compact=compact)
    # radiance, hit, albedo, normal (the returned rng state of a dead lane
    # depends on how many loop iterations ran after it died)
    return [np.asarray(x) for x in integrator.trace_wavefront(
        r.dscene, r.config, opts, ro, rd, rng)[:4]]


@pytest.fixture
def small_boundaries(monkeypatch):
    monkeypatch.setattr(integrator, "COMPACT_MIN_LANES", 256)
    monkeypatch.setattr(integrator, "COMPACT_MIN_CAP", 128)
    monkeypatch.setitem(integrator.COMPACT_DIV, "gather", 2)
    monkeypatch.setitem(integrator.COMPACT_DIV, "slice", 2)

    def set_levels(kind, levels):
        monkeypatch.setitem(integrator.COMPACT_LEVELS, kind, levels)

    return set_levels


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_wavefront_gather_compaction_bit_identical(small_boundaries, cornellbox,
                                                   levels):
    """Unsorted wavefronts: the gather boundary (levels 1-3: caps 512,
    256, 128 lanes) matches the single while_loop bit for bit."""
    small_boundaries("gather", levels)
    assert integrator.TraceOptions().compact  # the renderer's default
    plain = _trace(cornellbox, False, False)
    compacted = _trace(cornellbox, False, True)
    for a, b in zip(plain, compacted):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_wavefront_sorted_slice_compaction_bit_identical(small_boundaries,
                                                         cornellbox, levels):
    """Sorted wavefronts: the recursive slice boundary matches the single
    while_loop. Tolerance (not exact): the narrow tail compiles as a
    separate graph and XLA reassociates fusions around the in-body
    argsort+gathers differently at the two widths (same class of
    deviation as test_render.py's test_sorted_wavefront_bit_identical)."""
    small_boundaries("slice", levels)
    plain = _trace(cornellbox, True, False)
    compacted = _trace(cornellbox, True, True)
    for a, b in zip(plain, compacted):
        np.testing.assert_allclose(a, b, atol=2e-5)


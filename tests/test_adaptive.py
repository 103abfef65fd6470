"""Variance-adaptive sample allocation (beyond reference — the
reference renders fixed uniform spp). The estimator must stay an exact
per-pixel mean (warmup phase reproduces the uniform accumulation), the
allocation must follow variance, and the whole mode must be
deterministic and checkpoint-resumable."""

import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.render.renderer import (
    Params, Renderer, TraceState, make_trace_state,
)
from julia_raytracer.scene.generate import ensure_scene
from julia_raytracer.scene.loader import load_scene


def _render(adaptive, samples, warmup=2, res=32, seed=0):
    path = ensure_scene("cornellbox")
    scene = load_scene(path)
    p = Params(
        scene=path, resolution=res, samples=samples, bounces=4,
        sampler="path", batch=samples, seed=seed,
        adaptive=adaptive, adaptive_warmup=warmup,
    )
    r = Renderer(scene, p)
    state = make_trace_state(scene, p)
    state = r.trace_samples(state)
    return r, state


def test_warmup_matches_uniform():
    """With samples <= warmup the adaptive path must reproduce the
    standard uniform accumulation (same sample placement + RNG keys;
    only the arithmetic shape of the running mean differs)."""
    _, s_uni = _render(adaptive=False, samples=2)
    _, s_ada = _render(adaptive=True, samples=2, warmup=4)
    np.testing.assert_allclose(
        np.asarray(s_ada.image), np.asarray(s_uni.image), atol=2e-5
    )
    assert int(np.asarray(s_ada.counts).min()) == 2
    assert int(np.asarray(s_ada.counts).max()) == 2


def test_adaptive_allocation_and_determinism():
    _, s1 = _render(adaptive=True, samples=8, warmup=2)
    _, s2 = _render(adaptive=True, samples=8, warmup=2)
    c = np.asarray(s1.counts)
    n = s1.n_pixels
    # every pixel keeps its warmup floor; the batch budget is conserved
    assert c.min() >= 2
    assert c.sum() == 8 * n
    # allocation concentrates: sampled-above-average pixels have higher
    # tracked variance than the rest
    var = np.asarray(s1.m2) / np.maximum(c - 1, 1)
    hi = c > c.mean()
    assert hi.any() and (~hi).any()
    assert var[hi].mean() > var[~hi].mean()
    # bit-deterministic given the seed
    np.testing.assert_array_equal(np.asarray(s1.image), np.asarray(s2.image))
    np.testing.assert_array_equal(np.asarray(s1.counts), np.asarray(s2.counts))
    assert np.isfinite(np.asarray(s1.image)).all()


def test_adaptive_not_worse_than_uniform():
    """At an equal total-sample budget the adaptive image must land in
    the same quality neighborhood as uniform (vs a higher-spp uniform
    reference) — allocation is unbiased, so it can only redistribute
    noise, not add bias."""
    _, s_ref = _render(adaptive=False, samples=48, seed=3)
    ref = np.asarray(s_ref.image)[:, :3]
    _, s_uni = _render(adaptive=False, samples=12)
    _, s_ada = _render(adaptive=True, samples=12, warmup=3)
    mse_uni = float(((np.asarray(s_uni.image)[:, :3] - ref) ** 2).mean())
    mse_ada = float(((np.asarray(s_ada.image)[:, :3] - ref) ** 2).mean())
    assert mse_ada < mse_uni * 1.35, (mse_ada, mse_uni)


def test_adaptive_checkpoint_roundtrip(tmp_path):
    r, s = _render(adaptive=True, samples=6, warmup=2)
    path = str(tmp_path / "ck.npz")
    s.save(path)
    s2 = TraceState.load(path)
    assert s2.counts is not None and s2.m2 is not None
    np.testing.assert_array_equal(np.asarray(s.counts), np.asarray(s2.counts))
    # resuming continues the adaptive run without error
    s2.samples = 6
    r.params.samples = 8
    s2 = r.trace_samples(s2)
    assert int(np.asarray(s2.counts).sum()) == 8 * s2.n_pixels


def test_adaptive_budget_with_multiple_chunks(monkeypatch):
    """Tail chunks draw fewer lanes (n_live masking): with a chunk size
    that does not divide n_pixels, each round must still add EXACTLY
    n_pixels samples, and resuming a uniform path from an adaptive
    checkpoint must refuse."""
    import julia_raytracer.render.renderer as rmod

    monkeypatch.setattr(rmod, "MAX_CHUNK", 700)  # 1024 px -> 2 chunks
    r, s = _render(adaptive=True, samples=4, warmup=2)
    assert int(np.asarray(s.counts).sum()) == 4 * s.n_pixels
    # uniform resume of an adaptive state must refuse loudly
    r.params.adaptive = False
    r.params.samples = 6
    with pytest.raises(ValueError, match="adaptive"):
        r.trace_samples(s)

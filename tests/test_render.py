"""End-to-end renderer tests: estimator agreement, determinism,
chunking, checkpoint/resume, AOVs (generated cornellbox)."""

import numpy as np
import pytest

from julia_raytracer.render.renderer import Params, Renderer, make_trace_state


def render(scene, size=32, spp=16, sampler="path", bounces=4, **kw):
    params = Params(
        resolution=size, samples=spp, batch=spp, sampler=sampler,
        bounces=bounces, **kw
    )
    r = Renderer(scene, params)
    state = make_trace_state(scene, params)
    state = r.trace_samples(state)
    return r, state, r.get_image(state)


@pytest.mark.slow
def test_naive_close_to_path(cornellbox):
    _, _, img_n = render(cornellbox, size=48, spp=24, sampler="naive")
    _, _, img_p = render(cornellbox, size=48, spp=24, sampler="path")
    # both integrators estimate the same integral
    a = img_n[..., :3].mean(axis=(0, 1))
    b = img_p[..., :3].mean(axis=(0, 1))
    np.testing.assert_allclose(a, b, rtol=0.15)


def test_deterministic_same_seed(cornellbox):
    _, _, img1 = render(cornellbox, size=32, spp=2, sampler="path", seed=3)
    _, _, img2 = render(cornellbox, size=32, spp=2, sampler="path", seed=3)
    np.testing.assert_array_equal(img1, img2)


def test_different_seed_differs(cornellbox):
    _, _, img1 = render(cornellbox, size=32, spp=1, sampler="path", seed=0)
    _, _, img2 = render(cornellbox, size=32, spp=1, sampler="path", seed=9)
    assert np.abs(img1 - img2).max() > 0


def test_partial_chunk_accumulation(monkeypatch, cornellbox):
    """Regression (ADVICE r1 high): when n_pixels is not a multiple of the
    dispatch chunk, dynamic_update_slice used to clamp the last chunk's
    start index and write a shifted band of wrong pixels. Force a small
    chunk that doesn't divide 32x32=1024 and compare with the one-chunk
    render."""
    from julia_raytracer.render import renderer as renderer_mod

    _, _, ref = render(cornellbox, size=32, spp=2, sampler="path")
    monkeypatch.setattr(renderer_mod, "MAX_CHUNK", 384)  # 1024 = 2*384 + 256
    _, _, chunked = render(cornellbox, size=32, spp=2, sampler="path")
    # tiny atol: different chunk shapes fuse differently (float rounding);
    # the regression being guarded produced order-1 shifted pixel bands
    np.testing.assert_allclose(ref, chunked, atol=1e-5)


def test_checkpoint_resume(tmp_path, cornellbox):
    params = Params(resolution=32, samples=4, batch=2, bounces=4, sampler="path")
    r = Renderer(cornellbox, params)
    s = make_trace_state(cornellbox, params)
    s = r.trace_samples(s)  # 2 samples
    ckpt = str(tmp_path / "state.npz")
    s.save(ckpt)

    from julia_raytracer.render.renderer import TraceState

    s2 = TraceState.load(ckpt)
    assert s2.samples == 2
    s2 = r.trace_samples(s2)  # 2 more

    s_straight = make_trace_state(cornellbox, params)
    params2 = Params(resolution=32, samples=4, batch=4, bounces=4, sampler="path")
    r2 = Renderer(cornellbox, params2)
    s_straight = r2.trace_samples(s_straight)
    np.testing.assert_allclose(
        np.asarray(s2.image), np.asarray(s_straight.image), rtol=1e-5, atol=1e-6
    )


def test_aovs_cornellbox(cornellbox):
    # spp=1: the normal AOV is a running mean over samples (src/trace.jl:635),
    # so multi-sample edge pixels legitimately average orthogonal normals
    r, state, img = render(cornellbox, size=32, spp=1)
    aovs = r.get_aovs(state)
    assert aovs["albedo"].shape == (32, 32, 3)
    assert aovs["normal"].shape == (32, 32, 3)
    # every cornellbox primary ray hits geometry
    assert (aovs["hits"] > 0).mean() > 0.99
    # normals are ~unit where hit
    n = aovs["normal"].reshape(-1, 3)
    lens = np.linalg.norm(n, axis=1)
    assert (np.abs(lens - 1) < 1e-3).mean() > 0.99


def test_image_alpha_and_shape(cornellbox):
    _, state, img = render(cornellbox, size=32, spp=1)
    assert img.shape == (32, 32, 4)
    assert np.all(img[..., 3] == 1.0)  # all pixels hit -> alpha 1 (src/trace.jl:633)


def test_sorted_wavefront_bit_identical(cornellbox):
    """sort_rays is a pure lane permutation (unsorted at loop exit via
    idx): the traced image must match without it up to compiler fusion
    reassociation (the two graphs compile differently; observed max
    deviation 1.5e-8 on a handful of lanes)."""
    import jax.numpy as jnp

    from julia_raytracer.render.integrator import make_intersect, trace_wavefront
    from julia_raytracer.ops.camera import sample_camera
    from julia_raytracer.utils import rng as rng_mod

    params = Params(resolution=24, samples=1, bounces=4, sampler="path")
    r = Renderer(cornellbox, params)
    n = 24 * 24
    pix = jnp.arange(n, dtype=jnp.int32)
    rng = rng_mod.seed_state(pix, jnp.int32(0), 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    ij = jnp.stack([pix % 24, pix // 24], axis=-1)
    ro, rd = sample_camera(r.cam_arrays, ij, (24, 24), puv, luv, False)
    isec = make_intersect(r.dscene, r.config)
    outs = []
    for flag in (False, True):
        opts = r.options._replace(sort_rays=flag, fixed_iterations=0)
        rad, hit, alb, nrm, _ = trace_wavefront(
            r.dscene, r.config, opts, ro, rd, rng, intersect=isec
        )
        outs.append((np.asarray(rad), np.asarray(hit), np.asarray(alb), np.asarray(nrm)))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_allclose(a, b, atol=1e-6)

"""AOV-guided à-trous denoiser (render/denoise.py).

The reference stubs --denoise (src/jtrace.jl:43-46); ours is real, so the
test bar is quantitative: denoising a low-spp render must move it CLOSER
(in MSE) to a high-spp render of the same scene, while preserving alpha
and not washing out albedo edges.
"""

import numpy as np
import pytest

from julia_raytracer.render.denoise import denoise_image
from julia_raytracer.render.renderer import Params, Renderer, make_trace_state


def _render_state(scene, size, spp, seed=0):
    params = Params(resolution=size, samples=spp, batch=spp, sampler="path",
                    seed=seed)
    r = Renderer(scene, params)
    state = r.trace_samples(make_trace_state(scene, params))
    return r, state


@pytest.mark.slow
def test_denoise_reduces_mse(cornellbox):
    size = 48
    _, noisy = _render_state(cornellbox, size, spp=4)
    _, clean = _render_state(cornellbox, size, spp=64, seed=1)
    ref = np.asarray(clean.image[:, :3])

    den = denoise_image(noisy.image, noisy.albedo, noisy.normal,
                        noisy.width, noisy.height)
    err_noisy = ((np.asarray(noisy.image[:, :3]) - ref) ** 2).mean(axis=1)
    err_den = ((np.asarray(den[:, :3]) - ref) ** 2).mean(axis=1)
    # full-image MSE improves, and trimmed MSE (excluding each image's
    # worst 1% — emitter-edge pixels whose error is sub-pixel coverage
    # aliasing between two finite-spp renders, not filterable noise)
    # improves a lot
    assert err_den.mean() < 0.9 * err_noisy.mean(), (
        err_den.mean(), err_noisy.mean())

    def trimmed(e):
        return float(np.sort(e)[: int(len(e) * 0.99)].mean())

    assert trimmed(err_den) < 0.5 * trimmed(err_noisy), (
        trimmed(err_den), trimmed(err_noisy))

    # alpha passes through untouched
    np.testing.assert_array_equal(np.asarray(den[:, 3]),
                                  np.asarray(noisy.image[:, 3]))
    assert np.isfinite(np.asarray(den)).all()


@pytest.mark.slow
def test_denoise_preserves_albedo_edges(cornellbox):
    """The cornellbox red/green walls differ in albedo; the edge-stopping
    weights must keep the denoised wall colors distinct (no cross-wall
    bleeding beyond a few percent)."""
    size = 48
    _, st = _render_state(cornellbox, size, spp=16)
    den = np.asarray(
        denoise_image(st.image, st.albedo, st.normal, st.width, st.height)
    )[:, :3].reshape(size, size, 3)
    raw = np.asarray(st.image[:, :3]).reshape(size, size, 3)
    # columns well inside each wall, middle rows
    rows = slice(size // 3, 2 * size // 3)

    def chroma(img, cols):
        c = img[rows, cols].mean(axis=(0, 1))
        return c / max(c.sum(), 1e-8)

    # bleeding across the albedo edge would shift the wall CHROMATICITY
    # toward its neighbor (brightness may change — the filter smooths
    # illumination at scale — but color must not)
    np.testing.assert_allclose(
        chroma(den, slice(2, 6)), chroma(raw, slice(2, 6)), atol=0.05
    )
    np.testing.assert_allclose(
        chroma(den, slice(-6, -2)), chroma(raw, slice(-6, -2)), atol=0.05
    )
    # red wall stays red-dominant, green stays green-dominant
    left_den = den[rows, 2:6].mean(axis=(0, 1))
    right_den = den[rows, -6:-2].mean(axis=(0, 1))
    assert left_den[0] > left_den[1] and right_den[1] > right_den[0]


def test_denoise_flat_regions_smooth():
    """On synthetic data: constant albedo/normal, noisy illumination —
    the filter must drive per-pixel variance way down (it behaves as a
    wide low-pass when the guides say 'no edge')."""
    rng = np.random.default_rng(0)
    H = W = 32
    base = np.full((H * W, 3), 0.5, np.float32)
    noise = rng.normal(0, 0.2, (H * W, 3)).astype(np.float32)
    img = np.concatenate([base + noise, np.ones((H * W, 1), np.float32)], 1)
    albedo = np.full((H * W, 3), 0.7, np.float32)
    normal = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (H * W, 1))
    den = np.asarray(denoise_image(img, albedo, normal, W, H))
    var_in = float(img[:, :3].var())
    var_out = float(den[:, :3].var())
    assert var_out < 0.05 * var_in, (var_out, var_in)
    # and the mean is preserved (energy conservation of the filter)
    np.testing.assert_allclose(den[:, :3].mean(), img[:, :3].mean(), atol=0.01)


def test_denoise_accepts_padded_buffers():
    """trace_samples pads accumulation buffers to a chunk multiple when a
    frame spans several chunks (renderer.py stores the padded arrays in
    state).
    denoise_image must slice to height*width instead of crashing on the
    reshape, and the result must be identical to the unpadded call."""
    rng = np.random.default_rng(1)
    H, W = 24, 40
    n = H * W
    img = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    normal = np.tile(np.array([0.0, 0.0, 1.0], np.float32), (n, 1))
    pad = 173  # deliberately not a multiple of anything
    img_p = np.pad(img, ((0, pad), (0, 0)))
    alb_p = np.pad(albedo, ((0, pad), (0, 0)))
    nrm_p = np.pad(normal, ((0, pad), (0, 0)))
    den = np.asarray(denoise_image(img, albedo, normal, W, H))
    den_p = np.asarray(denoise_image(img_p, alb_p, nrm_p, W, H))
    assert den_p.shape == (n, 4)
    np.testing.assert_allclose(den_p, den, rtol=1e-6, atol=1e-6)

"""BSDF lobe property tests: white-furnace energy, sample<->pdf
consistency (MC integration), pdf positivity. These validate the lobes in
ops/bsdf.py against closed-form expectations rather than the reference's
untested code paths (the reference ships zero tests, SURVEY §4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.ops import bsdf

N = 4096


@pytest.fixture(scope="module")
def dirs():
    rng = np.random.default_rng(5)
    normal = jnp.asarray(np.tile([0.0, 0.0, 1.0], (N, 1)).astype(np.float32))
    out = np.array([0.3, -0.2, 0.95], np.float32)
    out /= np.linalg.norm(out)
    outgoing = jnp.asarray(np.tile(out, (N, 1)))
    rn = jnp.asarray(rng.random((N, 2), np.float32))
    rnl = jnp.asarray(rng.random(N, np.float32))
    return normal, outgoing, rn, rnl


def mc_reflectance(eval_fn, sample_fn, pdf_fn, normal, outgoing, rn):
    """E[f / pdf] over sampled directions = directional albedo."""
    incoming = sample_fn(rn)
    f = eval_fn(incoming)
    pdf = pdf_fn(incoming)
    ok = pdf > 1e-7
    est = jnp.where(ok[..., None], f / jnp.maximum(pdf, 1e-7)[..., None], 0.0)
    return np.asarray(est.mean(axis=0)), float(np.asarray(ok.mean()))


def test_matte_white_furnace(dirs):
    normal, outgoing, rn, _ = dirs
    color = jnp.ones((N, 3), jnp.float32)
    alb, frac = mc_reflectance(
        lambda i: bsdf.eval_matte(color, normal, outgoing, i),
        lambda r: bsdf.sample_matte(color, normal, outgoing, r),
        lambda i: bsdf.sample_matte_pdf(color, normal, outgoing, i),
        normal, outgoing, rn,
    )
    np.testing.assert_allclose(alb, 1.0, atol=0.01)  # lambertian albedo = color


def test_matte_tinted(dirs):
    normal, outgoing, rn, _ = dirs
    color = jnp.tile(jnp.asarray([[0.6, 0.3, 0.1]], jnp.float32), (N, 1))
    alb, _ = mc_reflectance(
        lambda i: bsdf.eval_matte(color, normal, outgoing, i),
        lambda r: bsdf.sample_matte(color, normal, outgoing, r),
        lambda i: bsdf.sample_matte_pdf(color, normal, outgoing, i),
        normal, outgoing, rn,
    )
    np.testing.assert_allclose(alb, [0.6, 0.3, 0.1], atol=0.01)


def test_glossy_energy_bounded(dirs):
    normal, outgoing, rn, _ = dirs
    color = jnp.full((N, 3), 0.8, jnp.float32)
    ior = jnp.full(N, 1.5, jnp.float32)
    rough = jnp.full(N, 0.2, jnp.float32)
    rnl = jnp.asarray(np.random.default_rng(2).random(N, np.float32))
    alb, _ = mc_reflectance(
        lambda i: bsdf.eval_glossy(color, ior, rough, normal, outgoing, i),
        lambda r: bsdf.sample_glossy(color, ior, rough, normal, outgoing, rnl, r),
        lambda i: bsdf.sample_glossy_pdf(color, ior, rough, normal, outgoing, i),
        normal, outgoing, rn,
    )
    assert (alb > 0.4).all() and (alb < 1.1).all()


def test_reflective_rough_energy(dirs):
    normal, outgoing, rn, _ = dirs
    color = jnp.full((N, 3), 0.9, jnp.float32)
    rough = jnp.full(N, 0.3, jnp.float32)
    alb, _ = mc_reflectance(
        lambda i: bsdf.eval_reflective(color, rough, normal, outgoing, i),
        lambda r: bsdf.sample_reflective(color, rough, normal, outgoing, r),
        lambda i: bsdf.sample_reflective_pdf(color, rough, normal, outgoing, i),
        normal, outgoing, rn,
    )
    assert (alb > 0.4).all() and (alb < 1.15).all()


def test_transparent_delta_energy(dirs):
    normal, outgoing, _, rnl = dirs
    color = jnp.full((N, 3), 0.7, jnp.float32)
    ior = jnp.full(N, 1.5, jnp.float32)
    incoming = bsdf.sample_transparent_delta(color, ior, normal, outgoing, rnl)
    f = bsdf.eval_transparent_delta(color, ior, normal, outgoing, incoming)
    pdf = bsdf.sample_transparent_delta_pdf(color, ior, normal, outgoing, incoming)
    est = np.asarray((f / jnp.maximum(pdf, 1e-7)[..., None]).mean(axis=0))
    # F + (1-F)*color averaged: between color and 1
    assert (est > 0.69).all() and (est < 1.01).all()


def test_refractive_delta_directions(dirs):
    normal, outgoing, _, rnl = dirs
    color = jnp.ones((N, 3), jnp.float32)
    ior = jnp.full(N, 1.5, jnp.float32)
    incoming = np.asarray(bsdf.sample_refractive_delta(color, ior, normal, outgoing, rnl))
    lens = np.linalg.norm(incoming, axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-4)
    # mix of reflections (z > 0) and refractions (z < 0)
    assert (incoming[:, 2] > 0).any() and (incoming[:, 2] < 0).any()


def test_fresnel_dielectric_limits():
    normal = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    grazing = jnp.asarray([[0.9999, 0.0, 0.0141]], jnp.float32)
    head_on = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    f0 = float(bsdf.fresnel_dielectric(1.5, normal, head_on)[0])
    fg = float(bsdf.fresnel_dielectric(1.5, normal, grazing)[0])
    np.testing.assert_allclose(f0, 0.04, atol=0.002)  # (0.5/2.5)^2
    assert fg > 0.9  # grazing -> ~1


def test_phasefunction_normalized():
    """HG phase integrates to 1 over the sphere."""
    rng = np.random.default_rng(0)
    n = 200_000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    outgoing = jnp.asarray(np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32))
    for g in (0.0, 0.4, -0.6):
        p = np.asarray(
            bsdf.eval_phasefunction(jnp.full(n, g, jnp.float32), outgoing, jnp.asarray(d))
        )
        integral = p.mean() * 4 * np.pi
        np.testing.assert_allclose(integral, 1.0, atol=0.02)


def test_sample_phasefunction_consistency():
    rng = np.random.default_rng(1)
    n = 100_000
    outgoing = jnp.asarray(np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32))
    g = jnp.full(n, 0.5, jnp.float32)
    rn = jnp.asarray(rng.random((n, 2), np.float32))
    inc = bsdf.sample_phasefunction(g, outgoing, rn)
    # mean cosine of HG = g (cosine between -outgoing and incoming)
    cosines = np.asarray(jnp.sum(-outgoing * inc, axis=-1))
    np.testing.assert_allclose(cosines.mean(), 0.5, atol=0.01)


def test_transmittance_sampling_consistency():
    rng = np.random.default_rng(3)
    n = 200_000
    density = jnp.tile(jnp.asarray([[0.5, 1.0, 2.0]], jnp.float32), (n, 1))
    maxd = jnp.full(n, 3.0, jnp.float32)
    rl = jnp.asarray(rng.random(n, np.float32))
    rd = jnp.asarray(rng.random(n, np.float32))
    dist = bsdf.sample_transmittance(density, maxd, rl, rd)
    trans = bsdf.eval_transmittance(density, dist)
    pdf = bsdf.sample_transmittance_pdf(density, dist, maxd)
    # E[T_c/pdf] = int_0^max e^{-d_c t} dt + e^{-d_c max} per channel
    est = np.asarray((trans / jnp.maximum(pdf, 1e-20)[..., None]).mean(axis=0))
    d = np.array([0.5, 1.0, 2.0])
    expect = (1 - np.exp(-d * 3.0)) / d + np.exp(-d * 3.0)
    np.testing.assert_allclose(est, expect, rtol=0.05)

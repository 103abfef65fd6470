"""Light-pdf fidelity (VERDICT r1 weak #3 / next #5).

The reference re-traces each light's private BVH for up to 100
successive hits when computing the light-sampling pdf
(src/trace.jl:1024-1043) — crucially those per-light BVHs contain only
the light's own geometry, so occluders are invisible to the march. Our
shipped path (`area_lights_pdf_exact`) sweeps every emissive element
directly, which is exhaustive by construction.

Round-1 shipped a truncated whole-scene march instead; on an occluded
many-light scene (the generated `manylights`: 13 small area lights above
four layers of slats), extra_steps=2 truncates a large share of the pdf
mass because occluder hits consume march steps without accumulating. That march is retained only as a fallback for scenes with
> EXACT_ELEMS emissive elements, with its budget raised accordingly.

This test pins the shipped exact sweep to an exhaustive whole-scene
march (64 steps — enough to enumerate every surface along any of its
rays) and documents the truncation error that motivated the redesign.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.ops.camera import sample_camera
from julia_raytracer.render import lights as L
from julia_raytracer.render.integrator import make_intersect
from julia_raytracer.render.renderer import camera_arrays, image_size_for
from julia_raytracer.render.scene_device import build_device_scene
from julia_raytracer.scene.loader import find_camera, load_scene
from julia_raytracer.utils import rng as rng_mod


@pytest.fixture(scope="module")
def manylights_pdfs():
    from julia_raytracer.scene.generate import ensure_scene

    scene = load_scene(ensure_scene("manylights"))
    dscene, config = build_device_scene(scene)
    counts = config.light_counts
    assert counts.n_instance >= 2, "need a multi-light scene"
    assert 0 < counts.total_inst_elems <= L.EXACT_ELEMS
    intersect = make_intersect(dscene, config)

    cam = scene.cameras[max(find_camera(scene, ""), 0)]
    ca = camera_arrays(cam)
    W, H = image_size_for(cam, 64)
    n = W * H
    pix = jnp.arange(n, dtype=jnp.int32)
    rng = rng_mod.seed_state(pix, jnp.int32(0), 0)
    puv, rng = rng_mod.rand2f(rng)
    luv, rng = rng_mod.rand2f(rng)
    rl, rng = rng_mod.rand1f(rng)
    rel, rng = rng_mod.rand1f(rng)
    ruv, rng = rng_mod.rand2f(rng)
    ij = jnp.stack([pix % W, pix // W], axis=-1)
    ro, rd = sample_camera(ca, ij, (W, H), puv, luv, False)
    h = intersect(ro, rd, jnp.full(n, 1e-4), jnp.full(n, 3.4e38))

    # sample a light direction from each primary hit
    position = h.position
    direction = L.sample_lights(
        dscene, dscene.lights, counts, position, rl, rel, ruv
    )
    first = intersect(position, direction, jnp.full(n, 1e-4), jnp.full(n, 3.4e38))

    exact = np.asarray(
        L.area_lights_pdf_exact(dscene.lights, counts, position, direction)
    )

    def march(steps):
        """The round-1 truncated whole-scene march (fallback path),
        forced by bypassing the EXACT_ELEMS dispatch."""
        pdf = jnp.zeros(n, jnp.float32)
        hit, prim, t, lnormal = first.hit, first.prim, first.t, first.gnormal
        t_cum = t
        pdf = pdf + L.area_light_hit_pdf(
            dscene.lights, prim, t_cum * t_cum, lnormal, direction, hit,
            total_elems=counts.total_inst_elems,
        )
        marching = hit
        for _ in range(steps):
            origin = position + direction * (t_cum + 1e-3)[..., None]
            tmin = jnp.full_like(t_cum, 1e-4)
            tmax = jnp.where(marching, jnp.float32(3.4028235e38), jnp.float32(1e-4))
            step = intersect(origin, direction, tmin, tmax)
            hit = step.hit & marching
            t_cum = jnp.where(hit, t_cum + 1e-3 + step.t, t_cum)
            pdf = pdf + L.area_light_hit_pdf(
                dscene.lights, step.prim, t_cum * t_cum, step.gnormal, direction, hit,
                total_elems=counts.total_inst_elems,
            )
            marching = hit
        return np.asarray(pdf)

    mask = np.asarray(h.hit)
    return exact, {s: march(s) for s in (2, 64)}, mask


def _rel_err(approx, exact, mask):
    sel = mask & (exact > 0)
    return float(np.abs(approx[sel] - exact[sel]).sum() / exact[sel].sum())


def test_exact_matches_exhaustive_march(manylights_pdfs):
    """The shipped element sweep equals an exhaustive whole-scene march
    (tolerance covers the march's 1e-3 per-step origin offsets)."""
    exact, marches, mask = manylights_pdfs
    err = _rel_err(marches[64], exact, mask)
    assert err < 0.01, f"exact vs 64-step march rel err {err:.4f}"


def test_truncated_march_underestimates(manylights_pdfs):
    """Documents the round-1 defect: a 2-step march loses a large
    fraction of pdf mass on occluded multi-light scenes (marches can
    only MISS emissive hits, never add them), hence the redesign."""
    exact, marches, mask = manylights_pdfs
    sel = mask
    assert (marches[2][sel] <= exact[sel] * (1 + 1e-4) + 1e-6).all()
    err2 = _rel_err(marches[2], exact, mask)
    assert err2 > 0.05, (
        f"expected substantial truncation at 2 steps, got {err2:.4f} — "
        "if occlusion vanished, revisit whether the march fallback budget "
        "in auto_light_pdf_steps is still justified"
    )


def test_auto_steps_rule():
    """The fallback march budget (only consulted when a scene exceeds
    EXACT_ELEMS emissive elements) is generous because occluder hits
    consume steps without accumulating."""
    assert L.auto_light_pdf_steps(n_lights=2, has_transmission=False) >= 4
    assert L.auto_light_pdf_steps(n_lights=2, has_transmission=True) >= 8
    assert L.auto_light_pdf_steps(n_lights=12, has_transmission=False) >= 8

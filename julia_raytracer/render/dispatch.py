"""Material-type BSDF dispatch as branchless masked selection.

The reference dispatches with an if/elseif chain per ray
(src/trace.jl:692-966). On a wavefront every lane carries its own
material type, so each present lobe is evaluated for the whole batch
(cheap elementwise math) and the per-lane result selected by type mask.
`subsurface` aliases to the refractive lobes (src/trace.jl:733-741) and
`volumetric` is delta-passthrough (src/trace.jl:771-773, 865-867).

Scene specialization: every dispatch takes `present`
(SceneConfig.present_types); lobes for material types the scene does not
contain are pruned AT TRACE TIME — they cost nothing, and a single-lobe
scene compiles to straight-line code with no select at all.

Rough (roughness != 0) lobes live in eval/sample/pdf_bsdfcos; delta
(roughness == 0) lobes in eval/sample/pdf_delta — the roughness gate at
the top of each reference function is reproduced with a where().
"""

from __future__ import annotations

import jax.numpy as jnp

from julia_raytracer.ops import bsdf
from julia_raytracer.scene.types import MaterialType

M = MaterialType


def _sel(mtype, pairs, default_shape, width=3, present=None):
    """Masked select: pairs = [(MaterialType, thunk -> [..., W])].

    `present` statically prunes lobes the scene cannot produce — pruned
    thunks are never traced. With exactly one live lobe the select
    disappears entirely."""
    live = [(t, f) for t, f in pairs if present is None or int(t) in present]
    if len(live) == 1:
        return live[0][1]()
    out = jnp.zeros(default_shape if width == 3 else default_shape[:-1], jnp.float32)
    for t, f in live:
        mask = mtype == t
        out = jnp.where(mask[..., None] if width == 3 else mask, f(), out)
    return out


def eval_bsdfcos(material, normal, outgoing, incoming, present=None):
    """src/trace.jl:692-755 (roughness == 0 -> black)."""
    c, r, ior, met = material.color, material.roughness, material.ior, material.metallic
    pairs = [
        (M.MATTE, lambda: bsdf.eval_matte(c, normal, outgoing, incoming)),
        (M.GLOSSY, lambda: bsdf.eval_glossy(c, ior, r, normal, outgoing, incoming)),
        (M.REFLECTIVE, lambda: bsdf.eval_reflective(c, r, normal, outgoing, incoming)),
        (M.TRANSPARENT, lambda: bsdf.eval_transparent(c, ior, r, normal, outgoing, incoming)),
        (M.REFRACTIVE, lambda: bsdf.eval_refractive(c, ior, r, normal, outgoing, incoming)),
        (M.SUBSURFACE, lambda: bsdf.eval_refractive(c, ior, r, normal, outgoing, incoming)),
        (M.GLTFPBR, lambda: bsdf.eval_gltfpbr(c, ior, r, met, normal, outgoing, incoming)),
    ]
    out = _sel(material.type, pairs, c.shape, present=present)
    return jnp.where((r == 0.0)[..., None], 0.0, out)


def sample_bsdfcos(material, normal, outgoing, rnl, rn, present=None):
    """src/trace.jl:780-849. Returns zero direction where roughness == 0."""
    c, r, ior, met = material.color, material.roughness, material.ior, material.metallic
    pairs = [
        (M.MATTE, lambda: bsdf.sample_matte(c, normal, outgoing, rn)),
        (M.GLOSSY, lambda: bsdf.sample_glossy(c, ior, r, normal, outgoing, rnl, rn)),
        (M.REFLECTIVE, lambda: bsdf.sample_reflective(c, r, normal, outgoing, rn)),
        (M.TRANSPARENT, lambda: bsdf.sample_transparent(c, ior, r, normal, outgoing, rnl, rn)),
        (M.REFRACTIVE, lambda: bsdf.sample_refractive(c, ior, r, normal, outgoing, rnl, rn)),
        (M.SUBSURFACE, lambda: bsdf.sample_refractive(c, ior, r, normal, outgoing, rnl, rn)),
        (M.GLTFPBR, lambda: bsdf.sample_gltfpbr(c, ior, r, met, normal, outgoing, rnl, rn)),
    ]
    out = _sel(material.type, pairs, c.shape, present=present)
    return jnp.where((r == 0.0)[..., None], 0.0, out)


def sample_bsdfcos_pdf(material, normal, outgoing, incoming, present=None):
    """src/trace.jl:874-943."""
    c, r, ior, met = material.color, material.roughness, material.ior, material.metallic
    pairs = [
        (M.MATTE, lambda: bsdf.sample_matte_pdf(c, normal, outgoing, incoming)),
        (M.GLOSSY, lambda: bsdf.sample_glossy_pdf(c, ior, r, normal, outgoing, incoming)),
        (M.REFLECTIVE, lambda: bsdf.sample_reflective_pdf(c, r, normal, outgoing, incoming)),
        (M.TRANSPARENT, lambda: bsdf.sample_transparent_pdf(c, ior, r, normal, outgoing, incoming)),
        (M.REFRACTIVE, lambda: bsdf.sample_refractive_pdf(c, ior, r, normal, outgoing, incoming)),
        (M.SUBSURFACE, lambda: bsdf.sample_refractive_pdf(c, ior, r, normal, outgoing, incoming)),
        (M.GLTFPBR, lambda: bsdf.sample_gltfpbr_pdf(c, ior, r, met, normal, outgoing, incoming)),
    ]
    out = _sel(material.type, pairs, c.shape, width=1, present=present)
    return jnp.where(r == 0.0, 0.0, out)


def eval_delta(material, normal, outgoing, incoming, present=None):
    """src/trace.jl:757-778 (roughness != 0 -> black)."""
    c, ior = material.color, material.ior
    pairs = [
        (M.REFLECTIVE, lambda: bsdf.eval_reflective_delta(c, normal, outgoing, incoming)),
        (M.TRANSPARENT, lambda: bsdf.eval_transparent_delta(c, ior, normal, outgoing, incoming)),
        (M.REFRACTIVE, lambda: bsdf.eval_refractive_delta(c, ior, normal, outgoing, incoming)),
        (M.VOLUMETRIC, lambda: bsdf.eval_passthrough(c, normal, outgoing, incoming)),
    ]
    live = [(t, f) for t, f in pairs if present is None or int(t) in present]
    if not live:
        return jnp.zeros_like(c)
    out = _sel(material.type, live, c.shape)
    return jnp.where((material.roughness != 0.0)[..., None], 0.0, out)


def sample_delta(material, normal, outgoing, rnl, present=None):
    """src/trace.jl:851-872."""
    c, ior = material.color, material.ior
    pairs = [
        (M.REFLECTIVE, lambda: bsdf.sample_reflective_delta(c, normal, outgoing)),
        (M.TRANSPARENT, lambda: bsdf.sample_transparent_delta(c, ior, normal, outgoing, rnl)),
        (M.REFRACTIVE, lambda: bsdf.sample_refractive_delta(c, ior, normal, outgoing, rnl)),
        (M.VOLUMETRIC, lambda: bsdf.sample_passthrough(c, normal, outgoing)),
    ]
    live = [(t, f) for t, f in pairs if present is None or int(t) in present]
    if not live:
        return jnp.zeros_like(c)
    out = _sel(material.type, live, c.shape)
    return jnp.where((material.roughness != 0.0)[..., None], 0.0, out)


def sample_delta_pdf(material, normal, outgoing, incoming, present=None):
    """src/trace.jl:945-966."""
    c, ior = material.color, material.ior
    pairs = [
        (M.REFLECTIVE, lambda: bsdf.sample_reflective_delta_pdf(c, normal, outgoing, incoming)),
        (M.TRANSPARENT, lambda: bsdf.sample_transparent_delta_pdf(c, ior, normal, outgoing, incoming)),
        (M.REFRACTIVE, lambda: bsdf.sample_refractive_delta_pdf(c, ior, normal, outgoing, incoming)),
        (M.VOLUMETRIC, lambda: bsdf.sample_passthrough_pdf(c, normal, outgoing, incoming)),
    ]
    live = [(t, f) for t, f in pairs if present is None or int(t) in present]
    if not live:
        return jnp.zeros(c.shape[:-1], jnp.float32)
    out = _sel(material.type, live, c.shape, width=1)
    return jnp.where(material.roughness != 0.0, 0.0, out)


# ---------------------------------------------------------------------------
# Volume scattering (src/trace.jl:1086-1112)
# ---------------------------------------------------------------------------


def eval_scattering(vol_scattering, vol_density, vol_anisotropy, outgoing, incoming):
    """scattering * density * phase (src/trace.jl:1086-1093)."""
    has = jnp.sum(jnp.abs(vol_density), axis=-1) > 0
    phase = bsdf.eval_phasefunction(vol_anisotropy, outgoing, incoming)
    return jnp.where(
        has[..., None], vol_scattering * vol_density * phase[..., None], 0.0
    )


def sample_scattering(vol_density, vol_anisotropy, outgoing, rn):
    """src/trace.jl:1095-1103."""
    has = jnp.sum(jnp.abs(vol_density), axis=-1) > 0
    incoming = bsdf.sample_phasefunction(vol_anisotropy, outgoing, rn)
    return jnp.where(has[..., None], incoming, 0.0)


def sample_scattering_pdf(vol_density, vol_anisotropy, outgoing, incoming):
    """src/trace.jl:1105-1112."""
    has = jnp.sum(jnp.abs(vol_density), axis=-1) > 0
    return jnp.where(
        has, bsdf.sample_phasefunction_pdf(vol_anisotropy, outgoing, incoming), 0.0
    )

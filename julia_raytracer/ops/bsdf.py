"""Yocto-style BSDF lobe library, vectorized + differentiable (jnp).

Every lobe is an (eval, sample, pdf) triple over batched [..., 3] vectors,
with semantics matching the reference shading layer (src/shading.jl):
matte, glossy, reflective (rough + delta), transparent (rough + delta),
refractive (rough + delta), gltfpbr, translucent, passthrough; GGX
microfacet D/G/sample; Fresnel dielectric/conductor/schlick.

Everything is branchless (masks + where) so the 8-way material dispatch
in ops/dispatch.py runs as straight elementwise code over a ray
wavefront. All guards use *safe* math (clamped sqrt/div arguments) so the
library is also the autodiff surface — reverse-mode gradients stay finite
even on masked-out lanes.
"""

from __future__ import annotations

import jax.numpy as jnp

from julia_raytracer.utils.vecmath import (
    basis_fromz,
    dot,
    dot_keep,
    mat_mul_vec,
    normalize,
    reflect,
    refract,
    transform_direction,
)

PIF = jnp.float32(jnp.pi)


def _safe_sqrt(x):
    """sqrt clamped at 0 with a finite gradient everywhere.

    The double-where keeps the forward value exact while preventing the
    0 * inf = NaN cotangent that plain sqrt(max(x, 0)) produces at x == 0
    (autodiff flows through unselected where branches)."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def _safe_div(a, b):
    return a / jnp.where(b == 0.0, 1.0, b)


def _k(x):
    """[...,] -> [..., 1] broadcast helper."""
    return x[..., None]


def _up_normal(normal, outgoing):
    """Face the normal toward the outgoing direction (pattern used by every
    lobe: src/shading.jl:22 etc.)."""
    return jnp.where(_k(dot(normal, outgoing)) <= 0.0, -normal, normal)


def same_hemisphere(normal, outgoing, incoming):
    return dot(normal, outgoing) * dot(normal, incoming) >= 0.0


# ---------------------------------------------------------------------------
# Hemisphere / microfacet sampling
# ---------------------------------------------------------------------------


def sample_hemisphere_cos(normal, ruv):
    """Cosine-weighted hemisphere sample (src/shading.jl:716-722)."""
    z = _safe_sqrt(ruv[..., 1])
    r = _safe_sqrt(1.0 - z * z)
    phi = 2.0 * PIF * ruv[..., 0]
    local = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    return transform_direction(basis_fromz(normal), local)


def sample_hemisphere_cos_pdf(normal, direction):
    """src/sampling.jl:219-222."""
    cosw = dot(normal, direction)
    return jnp.where(cosw <= 0.0, 0.0, cosw / PIF)


def microfacet_distribution(roughness, normal, halfway):
    """GGX D (src/shading.jl:734-750)."""
    cosine = dot(normal, halfway)
    r2 = roughness * roughness
    c2 = cosine * cosine
    denom = c2 * r2 + 1.0 - c2
    d = _safe_div(r2, PIF * denom * denom)
    return jnp.where(cosine <= 0.0, 0.0, d)


def _microfacet_shadowing1(roughness, normal, halfway, direction):
    """GGX Smith G1 (src/shading.jl:752-774)."""
    cosine = dot(normal, direction)
    cosineh = dot(halfway, direction)
    r2 = roughness * roughness
    c2 = cosine * cosine
    g = _safe_div(
        2.0 * jnp.abs(cosine),
        jnp.abs(cosine) + _safe_sqrt(c2 - r2 * c2 + r2),
    )
    return jnp.where(cosine * cosineh <= 0.0, 0.0, g)


def microfacet_shadowing(roughness, normal, halfway, outgoing, incoming):
    return _microfacet_shadowing1(
        roughness, normal, halfway, outgoing
    ) * _microfacet_shadowing1(roughness, normal, halfway, incoming)


def sample_microfacet(roughness, normal, rn):
    """GGX NDF sampling (src/shading.jl:787-803)."""
    phi = 2.0 * PIF * rn[..., 0]
    theta = jnp.arctan(roughness * _safe_sqrt(_safe_div(rn[..., 1], 1.0 - rn[..., 1])))
    st, ct = jnp.sin(theta), jnp.cos(theta)
    local = jnp.stack([jnp.cos(phi) * st, jnp.sin(phi) * st, ct], axis=-1)
    return transform_direction(basis_fromz(normal), local)


def sample_microfacet_pdf(roughness, normal, halfway):
    """D * cos (src/shading.jl:805-816)."""
    cosine = dot(normal, halfway)
    return jnp.where(
        cosine < 0.0, 0.0, microfacet_distribution(roughness, normal, halfway) * cosine
    )


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------


def fresnel_dielectric(eta, normal, outgoing):
    """src/shading.jl:695-714 (eta may be batched [...])."""
    cosw = jnp.abs(dot(normal, outgoing))
    sin2 = 1.0 - cosw * cosw
    eta2 = eta * eta
    cos2t = 1.0 - _safe_div(sin2, eta2)
    t0 = _safe_sqrt(cos2t)
    t1 = eta * t0
    t2 = eta * cosw
    rs = _safe_div(cosw - t1, cosw + t1)
    rp = _safe_div(t0 - t2, t0 + t2)
    f = (rs * rs + rp * rp) / 2.0
    return jnp.where(cos2t < 0.0, 1.0, f)  # total internal reflection


def fresnel_conductor(eta, etak, normal, outgoing):
    """src/shading.jl:831-851; eta/etak are [..., 3]."""
    cosw_raw = dot(normal, outgoing)
    cosw = jnp.clip(cosw_raw, -1.0, 1.0)
    cos2 = cosw * cosw
    sin2 = jnp.clip(1.0 - cos2, 0.0, 1.0)
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - _k(sin2)
    a2plusb2 = _safe_sqrt(t0 * t0 + 4.0 * eta2 * etak2)
    t1 = a2plusb2 + _k(cos2)
    a = _safe_sqrt((a2plusb2 + t0) / 2.0)
    t2 = 2.0 * a * _k(cosw)
    rs = _safe_div(t1 - t2, t1 + t2)
    t3 = _k(cos2) * a2plusb2 + _k(sin2 * sin2)
    t4 = t2 * _k(sin2)
    rp = rs * _safe_div(t3 - t4, t3 + t4)
    f = (rp + rs) / 2.0
    return jnp.where(_k(cosw_raw) <= 0.0, 0.0, f)


def fresnel_schlick(reflectivity, normal, outgoing):
    cosw = jnp.abs(dot(normal, outgoing))
    return reflectivity + (1.0 - reflectivity) * _k((1.0 - cosw) ** 5)


def eta_to_reflectivity(eta):
    return ((eta - 1.0) * (eta - 1.0)) / ((eta + 1.0) * (eta + 1.0))


def reflectivity_to_eta(reflectivity):
    """src/shading.jl:820-823."""
    r = jnp.clip(reflectivity, 0.0, 0.99)
    return (1.0 + _safe_sqrt(r)) / (1.0 - _safe_sqrt(r))


# ---------------------------------------------------------------------------
# Matte (src/shading.jl:14-37)
# ---------------------------------------------------------------------------


def eval_matte(color, normal, outgoing, incoming):
    f = color / PIF * _k(jnp.abs(dot(normal, incoming)))
    return jnp.where(_k(same_strict(normal, outgoing, incoming)), f, 0.0)


def same_strict(normal, outgoing, incoming):
    """dot products strictly same-signed (the `<= 0 -> zero` guard)."""
    return dot(normal, incoming) * dot(normal, outgoing) > 0.0


def sample_matte(color, normal, outgoing, rn):
    return sample_hemisphere_cos(_up_normal(normal, outgoing), rn)


def sample_matte_pdf(color, normal, outgoing, incoming):
    pdf = sample_hemisphere_cos_pdf(_up_normal(normal, outgoing), incoming)
    return jnp.where(same_strict(normal, outgoing, incoming), pdf, 0.0)


# ---------------------------------------------------------------------------
# Glossy (src/shading.jl:39-101)
# ---------------------------------------------------------------------------


def eval_glossy(color, ior, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    f1 = fresnel_dielectric(ior, up, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_dielectric(ior, halfway, incoming)
    d = microfacet_distribution(roughness, up, halfway)
    g = microfacet_shadowing(roughness, up, halfway, outgoing, incoming)
    cos_i = dot(up, incoming)
    cos_o = dot(up, outgoing)
    diffuse = color * _k(1.0 - f1) / PIF * _k(jnp.abs(cos_i))
    spec = _k(_safe_div(f * d * g, 4.0 * cos_o * cos_i) * jnp.abs(cos_i))
    return jnp.where(_k(same_strict(normal, outgoing, incoming)), diffuse + spec, 0.0)


def sample_glossy(color, ior, roughness, normal, outgoing, rnl, rn):
    up = _up_normal(normal, outgoing)
    f1 = fresnel_dielectric(ior, up, outgoing)
    halfway = sample_microfacet(roughness, up, rn)
    refl = reflect(outgoing, halfway)
    refl = jnp.where(
        _k(same_hemisphere(up, outgoing, refl)), refl, jnp.zeros_like(refl)
    )
    diff = sample_hemisphere_cos(up, rn)
    return jnp.where(_k(rnl < f1), refl, diff)


def sample_glossy_pdf(color, ior, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    f = fresnel_dielectric(ior, up, outgoing)
    pdf = f * _safe_div(
        sample_microfacet_pdf(roughness, up, halfway),
        4.0 * jnp.abs(dot(outgoing, halfway)),
    ) + (1.0 - f) * sample_hemisphere_cos_pdf(up, incoming)
    return jnp.where(same_strict(normal, outgoing, incoming), pdf, 0.0)


# ---------------------------------------------------------------------------
# Reflective / metal (src/shading.jl:103-252)
# ---------------------------------------------------------------------------


def eval_reflective(color, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_conductor(
        reflectivity_to_eta(color), jnp.zeros_like(color), halfway, incoming
    )
    d = microfacet_distribution(roughness, up, halfway)
    g = microfacet_shadowing(roughness, up, halfway, outgoing, incoming)
    cos_i = dot(up, incoming)
    cos_o = dot(up, outgoing)
    val = f * _k(_safe_div(d * g, 4.0 * cos_o * cos_i) * jnp.abs(cos_i))
    return jnp.where(_k(same_strict(normal, outgoing, incoming)), val, 0.0)


def sample_reflective(color, roughness, normal, outgoing, rn):
    up = _up_normal(normal, outgoing)
    halfway = sample_microfacet(roughness, up, rn)
    incoming = reflect(outgoing, halfway)
    return jnp.where(
        _k(same_hemisphere(up, outgoing, incoming)), incoming, jnp.zeros_like(incoming)
    )


def sample_reflective_pdf(color, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    pdf = _safe_div(
        sample_microfacet_pdf(roughness, up, halfway),
        4.0 * jnp.abs(dot(outgoing, halfway)),
    )
    return jnp.where(same_strict(normal, outgoing, incoming), pdf, 0.0)


def eval_reflective_delta(color, normal, outgoing, incoming):
    """src/shading.jl:202-213."""
    up = _up_normal(normal, outgoing)
    f = fresnel_conductor(
        reflectivity_to_eta(color), jnp.zeros_like(color), up, outgoing
    )
    return jnp.where(_k(same_strict(normal, outgoing, incoming)), f, 0.0)


def sample_reflective_delta(color, normal, outgoing):
    return reflect(outgoing, _up_normal(normal, outgoing))


def sample_reflective_delta_pdf(color, normal, outgoing, incoming):
    return jnp.where(same_strict(normal, outgoing, incoming), 1.0, 0.0)


# ---------------------------------------------------------------------------
# glTF PBR (src/shading.jl:254-321)
# ---------------------------------------------------------------------------


def eval_gltfpbr(color, ior, roughness, metallic, normal, outgoing, incoming):
    ior3 = jnp.broadcast_to(_k(ior), color.shape)
    reflectivity = eta_to_reflectivity(ior3) * _k(1.0 - metallic) + color * _k(metallic)
    up = _up_normal(normal, outgoing)
    f1 = fresnel_schlick(reflectivity, up, outgoing)
    halfway = normalize(incoming + outgoing)
    f = fresnel_schlick(reflectivity, halfway, incoming)
    d = microfacet_distribution(roughness, up, halfway)
    g = microfacet_shadowing(roughness, up, halfway, outgoing, incoming)
    cos_i = dot(up, incoming)
    cos_o = dot(up, outgoing)
    diffuse = color * _k(1.0 - metallic) * (1.0 - f1) / PIF * _k(jnp.abs(cos_i))
    spec = f * _k(_safe_div(d * g, 4.0 * cos_o * cos_i) * jnp.abs(cos_i))
    return jnp.where(_k(same_strict(normal, outgoing, incoming)), diffuse + spec, 0.0)


def sample_gltfpbr(color, ior, roughness, metallic, normal, outgoing, rnl, rn):
    up = _up_normal(normal, outgoing)
    ior3 = jnp.broadcast_to(_k(ior), color.shape)
    reflectivity = eta_to_reflectivity(ior3) * _k(1.0 - metallic) + color * _k(metallic)
    f_mean = jnp.mean(fresnel_schlick(reflectivity, up, outgoing), axis=-1)
    halfway = sample_microfacet(roughness, up, rn)
    refl = reflect(outgoing, halfway)
    refl = jnp.where(
        _k(same_hemisphere(up, outgoing, refl)), refl, jnp.zeros_like(refl)
    )
    diff = sample_hemisphere_cos(up, rn)
    return jnp.where(_k(rnl < f_mean), refl, diff)


def sample_gltfpbr_pdf(color, ior, roughness, metallic, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    halfway = normalize(outgoing + incoming)
    ior3 = jnp.broadcast_to(_k(ior), color.shape)
    reflectivity = eta_to_reflectivity(ior3) * _k(1.0 - metallic) + color * _k(metallic)
    f = jnp.mean(fresnel_schlick(reflectivity, up, outgoing), axis=-1)
    pdf = f * _safe_div(
        sample_microfacet_pdf(roughness, up, halfway),
        4.0 * jnp.abs(dot(outgoing, halfway)),
    ) + (1.0 - f) * sample_hemisphere_cos_pdf(up, incoming)
    return jnp.where(same_strict(normal, outgoing, incoming), pdf, 0.0)


# ---------------------------------------------------------------------------
# Transparent (src/shading.jl:323-446)
# ---------------------------------------------------------------------------


def eval_transparent(color, ior, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0.0
    # reflection branch
    h_r = normalize(incoming + outgoing)
    f_r = fresnel_dielectric(ior, h_r, outgoing)
    d_r = microfacet_distribution(roughness, up, h_r)
    g_r = microfacet_shadowing(roughness, up, h_r, outgoing, incoming)
    cos_i = dot(up, incoming)
    cos_o = dot(up, outgoing)
    refl = _k(_safe_div(f_r * d_r * g_r, 4.0 * cos_o * cos_i) * jnp.abs(cos_i))
    # transmission branch (mirror trick, src/shading.jl:340-349)
    reflected = reflect(-incoming, up)
    h_t = normalize(reflected + outgoing)
    f_t = fresnel_dielectric(ior, h_t, outgoing)
    d_t = microfacet_distribution(roughness, up, h_t)
    g_t = microfacet_shadowing(roughness, up, h_t, outgoing, reflected)
    cos_r = dot(up, reflected)
    trans = color * _k(
        _safe_div((1.0 - f_t) * d_t * g_t, 4.0 * cos_o * cos_r) * jnp.abs(cos_r)
    )
    return jnp.where(_k(same), refl, trans)


def sample_transparent(color, ior, roughness, normal, outgoing, rnl, rn):
    up = _up_normal(normal, outgoing)
    halfway = sample_microfacet(roughness, up, rn)
    f = fresnel_dielectric(ior, halfway, outgoing)
    refl = reflect(outgoing, halfway)
    refl = jnp.where(
        _k(same_hemisphere(up, outgoing, refl)), refl, jnp.zeros_like(refl)
    )
    trans = -reflect(reflect(outgoing, halfway), up)
    trans = jnp.where(
        _k(same_hemisphere(up, outgoing, trans)), jnp.zeros_like(trans), trans
    )
    return jnp.where(_k(rnl < f), refl, trans)


def sample_transparent_pdf(color, ior, roughness, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0.0
    h_r = normalize(incoming + outgoing)
    pdf_r = fresnel_dielectric(ior, h_r, outgoing) * _safe_div(
        sample_microfacet_pdf(roughness, up, h_r),
        4.0 * jnp.abs(dot(outgoing, h_r)),
    )
    reflected = reflect(-incoming, up)
    h_t = normalize(reflected + outgoing)
    pdf_t = _safe_div(
        (1.0 - fresnel_dielectric(ior, h_t, outgoing))
        * sample_microfacet_pdf(roughness, up, h_t),
        4.0 * jnp.abs(dot(outgoing, h_t)),
    )
    return jnp.where(same, pdf_r, pdf_t)


def eval_transparent_delta(color, ior, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0.0
    f = fresnel_dielectric(ior, up, outgoing)
    ones = jnp.ones_like(color)
    return jnp.where(_k(same), ones * _k(f), color * _k(1.0 - f))


def sample_transparent_delta(color, ior, normal, outgoing, rnl):
    up = _up_normal(normal, outgoing)
    f = fresnel_dielectric(ior, up, outgoing)
    return jnp.where(_k(rnl < f), reflect(outgoing, up), -outgoing)


def sample_transparent_delta_pdf(color, ior, normal, outgoing, incoming):
    up = _up_normal(normal, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0.0
    f = fresnel_dielectric(ior, up, outgoing)
    return jnp.where(same, f, 1.0 - f)


# ---------------------------------------------------------------------------
# Refractive (src/shading.jl:448-604); subsurface aliases to these
# ---------------------------------------------------------------------------


def eval_refractive(color, ior, roughness, normal, outgoing, incoming):
    entering = dot(normal, outgoing) >= 0.0
    up = jnp.where(_k(entering), normal, -normal)
    rel_ior = jnp.where(entering, ior, _safe_div(1.0, ior))
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0.0
    cos_no = dot(normal, outgoing)
    cos_ni = dot(normal, incoming)
    # reflection
    h_r = normalize(incoming + outgoing)
    f_r = fresnel_dielectric(rel_ior, h_r, outgoing)
    d_r = microfacet_distribution(roughness, up, h_r)
    g_r = microfacet_shadowing(roughness, up, h_r, outgoing, incoming)
    refl = _k(
        _safe_div(f_r * d_r * g_r, jnp.abs(4.0 * cos_no * cos_ni)) * jnp.abs(cos_ni)
    )
    # transmission ([Walter 2007] eq. 21, src/shading.jl:466-481)
    sign = jnp.where(entering, 1.0, -1.0)
    h_t = -normalize(_k(rel_ior) * incoming + outgoing) * _k(sign)
    f_t = fresnel_dielectric(rel_ior, h_t, outgoing)
    d_t = microfacet_distribution(roughness, up, h_t)
    g_t = microfacet_shadowing(roughness, up, h_t, outgoing, incoming)
    denom = (rel_ior * dot(h_t, incoming) + dot(h_t, outgoing)) ** 2
    trans = _k(
        jnp.abs(
            _safe_div(dot(outgoing, h_t) * dot(incoming, h_t), cos_no * cos_ni)
        )
        * _safe_div((1.0 - f_t) * d_t * g_t, denom)
        * jnp.abs(cos_ni)
    )
    val = jnp.where(_k(same), refl, trans)
    return jnp.broadcast_to(val, color.shape) * jnp.ones_like(color)


def sample_refractive(color, ior, roughness, normal, outgoing, rnl, rn):
    entering = dot(normal, outgoing) >= 0.0
    up = jnp.where(_k(entering), normal, -normal)
    halfway = sample_microfacet(roughness, up, rn)
    rel_ior = jnp.where(entering, ior, _safe_div(1.0, ior))
    f = fresnel_dielectric(rel_ior, halfway, outgoing)
    refl = reflect(outgoing, halfway)
    refl = jnp.where(
        _k(same_hemisphere(up, outgoing, refl)), refl, jnp.zeros_like(refl)
    )
    inv_eta = jnp.where(entering, _safe_div(1.0, ior), ior)
    trans = refract(outgoing, halfway, inv_eta)
    trans = jnp.where(
        _k(same_hemisphere(up, outgoing, trans)), jnp.zeros_like(trans), trans
    )
    return jnp.where(_k(rnl < f), refl, trans)


def sample_refractive_pdf(color, ior, roughness, normal, outgoing, incoming):
    entering = dot(normal, outgoing) >= 0.0
    up = jnp.where(_k(entering), normal, -normal)
    rel_ior = jnp.where(entering, ior, _safe_div(1.0, ior))
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0.0
    h_r = normalize(incoming + outgoing)
    pdf_r = fresnel_dielectric(rel_ior, h_r, outgoing) * _safe_div(
        sample_microfacet_pdf(roughness, up, h_r),
        4.0 * jnp.abs(dot(outgoing, h_r)),
    )
    sign = jnp.where(entering, 1.0, -1.0)
    h_t = -normalize(_k(rel_ior) * incoming + outgoing) * _k(sign)
    denom = (rel_ior * dot(h_t, incoming) + dot(h_t, outgoing)) ** 2
    pdf_t = (
        (1.0 - fresnel_dielectric(rel_ior, h_t, outgoing))
        * sample_microfacet_pdf(roughness, up, h_t)
        * _safe_div(jnp.abs(dot(h_t, incoming)), denom)
    )
    return jnp.where(same, pdf_r, pdf_t)


def eval_refractive_delta(color, ior, normal, outgoing, incoming):
    """src/shading.jl:536-560 incl. the |ior-1| < 1e-3 passthrough case."""
    passthrough = jnp.abs(ior - 1.0) < 1e-3
    opposite = dot(normal, incoming) * dot(normal, outgoing) <= 0.0
    pass_val = jnp.where(_k(opposite), jnp.ones_like(color), jnp.zeros_like(color))
    entering = dot(normal, outgoing) >= 0.0
    rel_ior = jnp.where(entering, ior, _safe_div(1.0, ior))
    up = jnp.where(_k(entering), normal, -normal)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0.0
    val = jnp.where(
        _k(same),
        jnp.ones_like(color) * _k(f),
        jnp.ones_like(color) * _k(_safe_div(1.0, rel_ior * rel_ior) * (1.0 - f)),
    )
    return jnp.where(_k(passthrough), pass_val, val)


def sample_refractive_delta(color, ior, normal, outgoing, rnl):
    passthrough = jnp.abs(ior - 1.0) < 1e-3
    entering = dot(normal, outgoing) >= 0.0
    up = jnp.where(_k(entering), normal, -normal)
    rel_ior = jnp.where(entering, ior, _safe_div(1.0, ior))
    f = fresnel_dielectric(rel_ior, up, outgoing)
    refl = reflect(outgoing, up)
    trans = refract(outgoing, up, _safe_div(1.0, rel_ior))
    val = jnp.where(_k(rnl < f), refl, trans)
    return jnp.where(_k(passthrough), -outgoing, val)


def sample_refractive_delta_pdf(color, ior, normal, outgoing, incoming):
    passthrough = jnp.abs(ior - 1.0) < 1e-3
    opposite = dot(normal, incoming) * dot(normal, outgoing) < 0.0
    pass_pdf = jnp.where(opposite, 1.0, 0.0)
    entering = dot(normal, outgoing) >= 0.0
    rel_ior = jnp.where(entering, ior, _safe_div(1.0, ior))
    up = jnp.where(_k(entering), normal, -normal)
    f = fresnel_dielectric(rel_ior, up, outgoing)
    same = dot(normal, incoming) * dot(normal, outgoing) >= 0.0
    pdf = jnp.where(same, f, 1.0 - f)
    return jnp.where(passthrough, pass_pdf, pdf)


# ---------------------------------------------------------------------------
# Translucent + passthrough (src/shading.jl:606-646)
# ---------------------------------------------------------------------------


def eval_translucent(color, normal, outgoing, incoming):
    opposite = dot(normal, incoming) * dot(normal, outgoing) < 0.0
    f = color / PIF * _k(jnp.abs(dot(normal, incoming)))
    return jnp.where(_k(opposite), f, 0.0)


def sample_translucent(color, normal, outgoing, rn):
    return sample_hemisphere_cos(-_up_normal(normal, outgoing), rn)


def sample_translucent_pdf(color, normal, outgoing, incoming):
    opposite = dot(normal, incoming) * dot(normal, outgoing) < 0.0
    pdf = sample_hemisphere_cos_pdf(-_up_normal(normal, outgoing), incoming)
    return jnp.where(opposite, pdf, 0.0)


def eval_passthrough(color, normal, outgoing, incoming):
    opposite = dot(normal, incoming) * dot(normal, outgoing) < 0.0
    return jnp.where(_k(opposite), jnp.ones_like(color), jnp.zeros_like(color))


def sample_passthrough(color, normal, outgoing):
    return -outgoing


def sample_passthrough_pdf(color, normal, outgoing, incoming):
    opposite = dot(normal, incoming) * dot(normal, outgoing) < 0.0
    return jnp.where(opposite, 1.0, 0.0)


# ---------------------------------------------------------------------------
# Volumes: transmittance + Henyey-Greenstein phase (src/shading.jl:648-693)
# ---------------------------------------------------------------------------

F32_BIG = jnp.float32(3.4028235e38)


def eval_transmittance(density, distance):
    return jnp.exp(-density * _k(distance))


def sample_transmittance(density, max_distance, rl, rd):
    """Channel-random exponential distance sampling (src/shading.jl:652-661)."""
    channel = jnp.clip((rl * 3.0).astype(jnp.int32), 0, 2)
    dens = jnp.take_along_axis(density, channel[..., None], axis=-1)[..., 0]
    distance = jnp.where(
        dens == 0.0, F32_BIG, -jnp.log(jnp.maximum(1.0 - rd, 1e-38)) / jnp.where(dens == 0, 1.0, dens)
    )
    return jnp.minimum(distance, max_distance)


def sample_transmittance_pdf(density, distance, max_distance):
    inside = distance < max_distance
    pdf_in = jnp.sum(density * jnp.exp(-density * _k(distance)), axis=-1) / 3.0
    pdf_out = jnp.sum(jnp.exp(-density * _k(max_distance)), axis=-1) / 3.0
    return jnp.where(inside, pdf_in, pdf_out)


def eval_phasefunction(anisotropy, outgoing, incoming):
    """Henyey-Greenstein (src/shading.jl:671-675)."""
    cosine = -dot(outgoing, incoming)
    denom = 1.0 + anisotropy * anisotropy - 2.0 * anisotropy * cosine
    denom = jnp.maximum(denom, 1e-12)
    return (1.0 - anisotropy * anisotropy) / (4.0 * PIF * denom * _safe_sqrt(denom))


def sample_phasefunction(anisotropy, outgoing, rn):
    """src/shading.jl:677-690."""
    iso = jnp.abs(anisotropy) < 1e-3
    ct_iso = 1.0 - 2.0 * rn[..., 1]
    denom = 1.0 + anisotropy - 2.0 * anisotropy * rn[..., 1]
    square = _safe_div(1.0 - anisotropy * anisotropy, denom)
    ct_aniso = _safe_div(
        1.0 + anisotropy * anisotropy - square * square, 2.0 * anisotropy
    )
    cos_theta = jnp.where(iso, ct_iso, ct_aniso)
    sin_theta = _safe_sqrt(1.0 - cos_theta * cos_theta)
    phi = 2.0 * PIF * rn[..., 0]
    local = jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )
    # mat * vec (column combination, src/shading.jl:689)
    return mat_mul_vec(basis_fromz(-outgoing), local)


def sample_phasefunction_pdf(anisotropy, outgoing, incoming):
    return eval_phasefunction(anisotropy, outgoing, incoming)

"""Camera ray generation (thin-lens + orthographic), wavefront-vectorized.

Matches eval_camera (src/scene.jl:372-411) and sample_camera's pixel
jitter / tent filter / lens disk (src/trace.jl:651-674).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from julia_raytracer.utils.vecmath import normalize, transform_direction, transform_point


class CameraArrays(NamedTuple):
    frame: jnp.ndarray  # f32 [4, 3]
    lens: jnp.ndarray  # f32 scalar
    film: jnp.ndarray
    aspect: jnp.ndarray
    focus: jnp.ndarray
    aperture: jnp.ndarray
    orthographic: bool  # static


def sample_disk(ruv):
    """Concentric-free polar disk sample (src/sampling.jl:207-211)."""
    r = jnp.sqrt(ruv[..., 1])
    phi = 2.0 * jnp.pi * ruv[..., 0]
    return jnp.stack([jnp.cos(phi) * r, jnp.sin(phi) * r], axis=-1)


def eval_camera(cam: CameraArrays, image_uv, lens_uv):
    """image_uv, lens_uv: [N, 2] -> (origin [N,3], direction [N,3])."""
    film_x = jnp.where(cam.aspect >= 1.0, cam.film, cam.film * cam.aspect)
    film_y = jnp.where(cam.aspect >= 1.0, cam.film / cam.aspect, cam.film)

    if not cam.orthographic:
        q = jnp.stack(
            [
                film_x * (0.5 - image_uv[..., 0]),
                film_y * (image_uv[..., 1] - 0.5),
                jnp.broadcast_to(cam.lens, image_uv[..., 0].shape),
            ],
            axis=-1,
        )
        dc = -normalize(q)
        e = jnp.stack(
            [
                lens_uv[..., 0] * cam.aperture / 2.0,
                lens_uv[..., 1] * cam.aperture / 2.0,
                jnp.zeros_like(lens_uv[..., 0]),
            ],
            axis=-1,
        )
        p = dc * (cam.focus / jnp.abs(dc[..., 2]))[..., None]
        d = normalize(p - e)
    else:
        scale = 1.0 / cam.lens
        qx = film_x * (0.5 - image_uv[..., 0]) * scale
        qy = film_y * (image_uv[..., 1] - 0.5) * scale
        e = jnp.stack(
            [
                -qx + lens_uv[..., 0] * cam.aperture / 2.0,
                -qy + lens_uv[..., 1] * cam.aperture / 2.0,
                jnp.zeros_like(qx),
            ],
            axis=-1,
        )
        p = jnp.stack([-qx, -qy, -jnp.broadcast_to(cam.focus, qx.shape)], axis=-1)
        d = normalize(p - e)
    origin = transform_point(cam.frame, e)
    direction = transform_direction(cam.frame, d)
    return origin, direction


def sample_camera(cam: CameraArrays, ij, image_size, puv, luv, tent: bool):
    """Pixel-jittered camera ray (src/trace.jl:651-674).

    ij: [N, 2] integer pixel coords; image_size: (w, h) static; puv/luv:
    [N, 2] uniforms. With `tent`, puv is warped by the tent filter
    (src/trace.jl:664-672).
    """
    w, h = image_size
    if tent:
        width, offset = 2.0, 0.5
        f = jnp.where(
            puv < 0.5, jnp.sqrt(2.0 * puv) - 1.0, 1.0 - jnp.sqrt(2.0 - 2.0 * puv)
        )
        puv = width * f + offset
    uv = jnp.stack(
        [
            (ij[..., 0].astype(jnp.float32) + puv[..., 0]) / w,
            (ij[..., 1].astype(jnp.float32) + puv[..., 1]) / h,
        ],
        axis=-1,
    )
    return eval_camera(cam, uv, sample_disk(luv))

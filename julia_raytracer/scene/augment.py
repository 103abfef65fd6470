"""Scene augmentation: --addsky and --envname, made real.

The reference accepts both flags but stubs them with a warning
(src/jtrace.jl:35-46, src/scene.jl:413 `add_sky`, src/sceneio.jl:95
`add_environment`). Here they work:

- add_environment: load an HDR/PNG panorama and append it as an
  emissive environment (the env-texel CDF machinery in render/lights.py
  then importance-samples it like any scene environment).
- add_sky: generate a procedural sun-sky panorama from the published
  Perez all-weather sky-luminance model with Preetham's turbidity fits
  (Preetham et al., "A Practical Analytic Model for Daylight", 1999) —
  an analytic formula, evaluated on an equirect grid in numpy, plus a
  physically-sized sun disk and a constant-albedo ground hemisphere.
"""

from __future__ import annotations

import numpy as np

from julia_raytracer.scene.types import EnvironmentData, SceneData


def add_environment(scene: SceneData, filename: str) -> None:
    """Append an environment light backed by the image at `filename`."""
    from julia_raytracer.scene.loader import load_texture

    tex = load_texture(filename)
    scene.textures.append(tex)
    scene.environments.append(
        EnvironmentData(
            emission=np.array([1.0, 1.0, 1.0], np.float32),
            emission_tex=len(scene.textures) - 1,
        )
    )


def _perez(theta, gamma, coef):
    """Perez sky-luminance distribution F(theta, gamma)."""
    A, B, C, D, E = coef
    cos_t = np.maximum(np.cos(theta), 1e-2)  # guard the horizon pole
    return (1.0 + A * np.exp(B / cos_t)) * (
        1.0 + C * np.exp(D * gamma) + E * np.cos(gamma) ** 2
    )


def make_sunsky(
    width: int = 1024,
    height: int = 512,
    sun_elevation: float = np.pi / 4,
    turbidity: float = 3.0,
    ground_albedo: float = 0.2,
    intensity: float = 1.0,
) -> np.ndarray:
    """Equirect [H, W, 4] linear-RGB sun-sky panorama.

    Sky: Perez model in xyY with Preetham's turbidity-linear coefficient
    fits and zenith chromaticity/luminance polynomials; converted to
    linear sRGB. Sun: a 0.255-degree disk whose radiance is set so its
    solid angle integrates to a plausible direct/diffuse ratio. Ground:
    albedo-scaled average horizon color.
    """
    T = float(turbidity)
    ts = np.pi / 2 - sun_elevation  # sun zenith angle

    # Preetham zenith luminance (Kcd/m^2) and chromaticity
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2 * ts)
    Yz = (4.0453 * T - 4.9710) * np.tan(chi) - 0.2155 * T + 2.4192
    tv = np.array([T * T, T, 1.0])
    sv = np.array([ts**3, ts**2, ts, 1.0])
    xz = tv @ np.array(
        [
            [0.00166, -0.00375, 0.00209, 0.0],
            [-0.02903, 0.06377, -0.03202, 0.00394],
            [0.11693, -0.21196, 0.06052, 0.25886],
        ]
    ) @ sv
    yz = tv @ np.array(
        [
            [0.00275, -0.00610, 0.00317, 0.0],
            [-0.04214, 0.08970, -0.04153, 0.00516],
            [0.15346, -0.26756, 0.06670, 0.26688],
        ]
    ) @ sv

    # Perez coefficients (luminance Y, chromaticities x, y)
    cY = np.array([0.1787 * T - 1.4630, -0.3554 * T + 0.4275,
                   -0.0227 * T + 5.3251, 0.1206 * T - 2.5771,
                   -0.0670 * T + 0.3703])
    cx = np.array([-0.0193 * T - 0.2592, -0.0665 * T + 0.0008,
                   -0.0004 * T + 0.2125, -0.0641 * T - 0.8989,
                   -0.0033 * T + 0.0452])
    cy = np.array([-0.0167 * T - 0.2608, -0.0950 * T + 0.0092,
                   -0.0079 * T + 0.2102, -0.0441 * T - 1.6537,
                   -0.0109 * T + 0.0529])

    # equirect directions (v=0 -> zenith)
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    theta = v * np.pi  # zenith angle
    phi = u * 2 * np.pi
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sun_dir = np.array(
        [np.sin(ts), 0.0, np.cos(ts)]
    )  # sun at phi=0
    # gamma: angle between pixel dir and sun dir
    cos_g = np.clip(
        st * np.cos(phi)[None, :] * sun_dir[0]
        + st * np.sin(phi)[None, :] * sun_dir[1]
        + ct * sun_dir[2],
        -1.0, 1.0,
    )
    gamma = np.arccos(cos_g)
    th = np.broadcast_to(theta[:, None], gamma.shape)

    def ratio(coef, z):
        return _perez(np.minimum(th, np.pi / 2 - 1e-3), gamma, coef) / _perez(
            np.zeros(1), np.array([ts]), coef
        ) * z

    Y = ratio(cY, max(Yz, 1e-3))
    x = ratio(cx, xz)
    y = ratio(cy, yz)

    # xyY -> XYZ -> linear sRGB
    y = np.clip(y, 1e-4, 1.0)
    X = x / y * Y
    Z = (1 - x - y) / y * Y
    r = 3.2406 * X - 1.5372 * Y - 0.4986 * Z
    g = -0.9689 * X + 1.8758 * Y + 0.0415 * Z
    b = 0.0557 * X - 0.2040 * Y + 1.0570 * Z
    rgb = np.clip(np.stack([r, g, b], axis=-1), 0.0, None)
    rgb *= intensity / max(Yz, 1e-3)  # normalize zenith to ~O(1)

    # sun disk: 0.255 deg angular radius, smooth limb
    sun_rad = np.deg2rad(0.255)
    limb = np.clip((sun_rad * 3 - gamma) / (sun_rad * 2), 0.0, 1.0)
    sun_col = np.array([1.0, 0.9, 0.75], np.float32)
    sun_scale = 50.0 * intensity * max(np.cos(ts), 0.05)
    rgb += (limb**4)[..., None] * sun_col * sun_scale

    # ground hemisphere: albedo times mean horizon color, falling off
    # with depression angle
    horizon = rgb[max(height // 2 - 1, 0)].mean(axis=0)  # [3]
    ground = (
        ground_albedo * horizon[None, None, :] * np.maximum(-ct, 0.0)[..., None]
    )  # [H, 1, 3] broadcast over phi
    below = th > np.pi / 2
    rgb = np.where(below[..., None], np.broadcast_to(ground, rgb.shape), rgb)

    out = np.concatenate(
        [rgb.astype(np.float32), np.ones((height, width, 1), np.float32)],
        axis=-1,
    )
    return out


def add_sky(
    scene: SceneData,
    sun_elevation: float = np.pi / 4,
    turbidity: float = 3.0,
    intensity: float = 1.0,
) -> None:
    """Append a procedural sun-sky environment (see make_sunsky)."""
    from julia_raytracer.scene.types import TextureData

    img = make_sunsky(
        sun_elevation=sun_elevation, turbidity=turbidity, intensity=intensity
    )
    h, w = img.shape[:2]
    scene.textures.append(
        TextureData(
            width=w, height=h, linear=True, pixels=img.reshape(-1, 4)
        )
    )
    scene.environments.append(
        EnvironmentData(
            emission=np.array([1.0, 1.0, 1.0], np.float32),
            emission_tex=len(scene.textures) - 1,
        )
    )

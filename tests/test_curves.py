"""Line/point (capsule) primitives through the full wavefront path
(VERDICT r1 'Missing #4'; reference src/geometry.jl:113-172,
src/bvh.jl:408-443, src/scene.jl:465-518). The hairball corpus blob is
stripped, so a synthetic capsule-hair ball exercises the wiring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from julia_raytracer.render.integrator import (
    TraceOptions, make_intersect, trace_wavefront,
)
from julia_raytracer.render.scene_device import build_device_scene
from julia_raytracer.scene.types import (
    CameraData, EnvironmentData, InstanceData, MaterialData, SceneData,
    ShapeData,
)
from julia_raytracer.utils import rng as rng_mod


def _hairball(n_hairs=400, seed=5):
    """Hair segments radiating off a sphere, plus per-vertex attrs."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_hairs, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    p0 = d * 0.5
    p1 = d * (0.9 + 0.2 * rng.random((n_hairs, 1), dtype=np.float32))
    positions = np.concatenate([p0, p1]).astype(np.float32)
    lines = np.stack(
        [np.arange(n_hairs), n_hairs + np.arange(n_hairs)], axis=1
    ).astype(np.int32)
    radius = np.full(2 * n_hairs, 0.04, np.float32)
    texcoords = np.concatenate(
        [np.zeros((n_hairs, 2)), np.ones((n_hairs, 2))]
    ).astype(np.float32)
    return ShapeData(
        lines=lines, positions=positions, radius=radius, texcoords=texcoords
    )


@pytest.fixture(scope="module")
def hair_scene():
    shapes = [
        _hairball(),
        ShapeData(  # ground quad
            quads=np.array([[0, 1, 2, 3]], np.int32),
            positions=np.array(
                [[-3, -1.5, -3], [3, -1.5, -3], [3, -1.5, 3], [-3, -1.5, 3]],
                np.float32,
            ),
        ),
        ShapeData(  # a few radius-points
            points=np.arange(3, dtype=np.int32),
            positions=np.array(
                [[1.6, 0.5, 0], [-1.6, 0.5, 0], [0, 1.6, 0]], np.float32
            ),
            radius=np.full(3, 0.15, np.float32),
        ),
    ]
    mats = [
        MaterialData(color=np.array([0.7, 0.4, 0.2], np.float32)),
        MaterialData(color=np.array([0.6, 0.6, 0.6], np.float32)),
    ]
    cam_frame = np.eye(4, 3, dtype=np.float32)
    cam_frame[3] = [0.0, 0.0, 4.0]  # back off so the ball fills the view
    scene = SceneData(
        cameras=[CameraData(aspect=1.0, frame=cam_frame)],
        shapes=shapes,
        materials=mats,
        instances=[
            InstanceData(shape=0, material=0),
            InstanceData(shape=1, material=1),
            InstanceData(shape=2, material=0),
        ],
        environments=[
            EnvironmentData(emission=np.array([0.8, 0.9, 1.0], np.float32))
        ],
    )
    return scene


def test_capsule_intersect_analytic(hair_scene):
    """A ray aimed dead-center at a known capsule must report the capsule,
    the right t, the right line param u, and a view-orthogonal normal."""
    dsc, cfg = build_device_scene(hair_scene)
    assert cfg.n_lines == 400 and cfg.n_points == 3
    isec = make_intersect(dsc, cfg)
    # aim at the midpoint of hair 0 from far +x of its axis... simpler:
    # construct the ray toward the capsule midpoint from the camera origin
    lv = np.asarray(dsc.line_verts)
    mid = 0.5 * (lv[0, 0] + lv[0, 1])
    ro = jnp.asarray(mid[None] + np.array([[0.0, 0.0, 5.0]], np.float32))
    rd = jnp.asarray(np.array([[0.0, 0.0, -1.0]], np.float32))
    h = isec(ro, rd, jnp.full(1, 1e-4), jnp.full(1, 3.4e38))
    h = jax.tree_util.tree_map(np.asarray, h)
    assert bool(h.hit[0])
    Q = dsc.prim_verts.shape[0]
    if h.prim[0] >= Q:  # hit a line (another hair could legitimately occlude)
        # t must place the ray point within radius of the axis point
        ray_pt = np.asarray(ro)[0] + float(h.t[0]) * np.asarray(rd)[0]
        li = int(h.prim[0]) - Q
        a, b = lv[li, 0], lv[li, 1]
        ax_pt = a + (b - a) * float(h.u[0])
        assert np.linalg.norm(ray_pt - ax_pt) <= 0.04 + 1e-4
        # reported position is the AXIS point (eval_position semantics)
        np.testing.assert_allclose(h.position[0], ax_pt, atol=1e-4)
        # v = normalized orthogonal distance in [0, 1]
        assert 0.0 <= float(h.v[0]) <= 1.0 + 1e-5
        assert int(h.instance[0]) == 0


def test_point_intersect(hair_scene):
    dsc, cfg = build_device_scene(hair_scene)
    isec = make_intersect(dsc, cfg)
    # straight at point prim 0 from +x
    ro = jnp.asarray(np.array([[5.0, 0.5, 0.0]], np.float32))
    rd = jnp.asarray(np.array([[-1.0, 0.0, 0.0]], np.float32))
    h = jax.tree_util.tree_map(
        np.asarray, isec(ro, rd, jnp.full(1, 1e-4), jnp.full(1, 3.4e38))
    )
    assert bool(h.hit[0])
    Q = dsc.prim_verts.shape[0]
    assert int(h.prim[0]) == Q + cfg.n_lines + 0
    # position is the point center; t is the plane through the center
    np.testing.assert_allclose(h.position[0], [1.6, 0.5, 0.0], atol=1e-5)
    np.testing.assert_allclose(h.t[0], 3.4, atol=1e-4)
    assert int(h.instance[0]) == 2


def test_hairball_render_smoke(hair_scene):
    """Full wavefront render of the hairball: finite radiance, hair
    actually visible (hits on line prims), no NaN normals."""
    dsc, cfg = build_device_scene(hair_scene)
    n = 32 * 32
    pix = jnp.arange(n, dtype=jnp.int32)
    from julia_raytracer.ops.camera import sample_camera
    from julia_raytracer.render.renderer import camera_arrays

    cam = camera_arrays(hair_scene.cameras[0])
    rngs = rng_mod.seed_state(pix, jnp.int32(0), 0)
    puv, rngs2 = rng_mod.rand2f(rngs)
    luv, rngs2 = rng_mod.rand2f(rngs2)
    ij = jnp.stack([pix % 32, pix // 32], axis=-1)
    ro, rd = sample_camera(cam, ij, (32, 32), puv, luv, False)
    opts = TraceOptions(sampler="path", bounces=4)
    rad, hit, alb, nrm, _ = trace_wavefront(
        dsc, cfg, opts, ro, rd, rngs2, intersect=make_intersect(dsc, cfg)
    )
    rad = np.asarray(rad)
    assert np.isfinite(rad).all()
    assert rad.max() > 0
    # the hairball fills the view center: some first hits must be lines
    isec = make_intersect(dsc, cfg)
    h = jax.tree_util.tree_map(
        np.asarray,
        isec(ro, rd, jnp.full(n, 1e-4), jnp.full(n, 3.4e38)),
    )
    Q = dsc.prim_verts.shape[0]
    assert ((h.prim >= Q) & (h.prim < Q + cfg.n_lines) & h.hit).sum() > 20

"""Seeded Yocto-format scene generator: JSON + binary PLY (+ HDR).

Every scene the renderer, its tests and `chip_smoke.py` render is built
here from a seed and written into `<checkout>/scenes/<name>/`, which git
ignores; `ensure_scene` regenerates a scene when it is absent. The same
(name, seed) always gives the same bytes. Nothing is downloaded.

Scenes:
- `cornellbox`: the Cornell box of Yocto/GL's `make_cornellbox()`
  (yocto_scene.cpp): 5 walls, a short and a tall box and a quad area
  light with emission (17, 12, 4) — 8 shapes, 36 triangles. Shapes,
  materials and instances are in name order, as Yocto's JSON export
  writes them, so the light is material 4. Fixed geometry: the seed
  changes nothing.
- `kitchen_class`: a closed room holding ~1.44M triangles over 299
  shapes (the corpus kitchen's recorded statistics), lit by quad area
  lights, with matte, glossy and refractive materials. The geometry is
  seeded, displaced, tessellated superellipsoids and tori, scattered so
  that they overlap, which gives the BVH real depth.
- `envmap`: shapes on a floor lit only by an HDR environment map.
- `manylights`: a room with 13 small area lights on a grid under the
  ceiling and four layers of occluding slats below them, so light
  directions cross several surfaces before reaching an emitter.

Run `python -m julia_raytracer.scene.generate [names...] [--seed N]`.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from julia_raytracer.utils.imgio import save_hdr

SCENES_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "scenes",
)


# ---------------------------------------------------------------------------
# writers


def write_ply(path, positions, faces, normals=None, texcoords=None) -> None:
    """Binary little-endian PLY: float vertex properties and one
    `list uchar int vertex_indices` face element (triangles or quads)."""
    positions = np.asarray(positions, np.float32)
    faces = np.asarray(faces, np.int32)
    cols = [("x", positions[:, 0]), ("y", positions[:, 1]), ("z", positions[:, 2])]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        cols += [("nx", normals[:, 0]), ("ny", normals[:, 1]), ("nz", normals[:, 2])]
    if texcoords is not None:
        texcoords = np.asarray(texcoords, np.float32)
        cols += [("u", texcoords[:, 0]), ("v", texcoords[:, 1])]
    vdt = np.dtype([(n, "<f4") for n, _ in cols])
    vert = np.empty(len(positions), vdt)
    for n, c in cols:
        vert[n] = c
    k = faces.shape[1]
    fdt = np.dtype([("n", "u1"), ("i", "<i4", (k,))])
    face = np.empty(len(faces), fdt)
    face["n"] = k
    face["i"] = faces
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(positions)}"]
    header += [f"property float {n}" for n, _ in cols]
    header += [f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(vert.tobytes())
        f.write(face.tobytes())


class _SceneWriter:
    """Accumulates a Yocto JSON scene whose assets go under `root`."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "shapes"), exist_ok=True)
        self.j = {"asset": {"generator": "julia_raytracer.scene.generate"},
                  "cameras": [], "textures": [], "materials": [],
                  "shapes": [], "instances": [], "environments": []}

    def camera(self, name, lookat=None, frame=None, **kw) -> None:
        cam = {"name": name, **kw}
        if lookat is not None:
            cam["lookat"] = [float(x) for x in np.reshape(lookat, -1)]
        if frame is not None:
            cam["frame"] = [float(x) for x in np.reshape(frame, -1)]
        self.j["cameras"].append(cam)

    def material(self, name, **kw) -> int:
        m = {"name": name}
        for k, v in kw.items():
            m[k] = [float(x) for x in v] if np.ndim(v) else v
        self.j["materials"].append(m)
        return len(self.j["materials"]) - 1

    def shape(self, name, positions, faces, normals=None, texcoords=None) -> int:
        uri = f"shapes/{name}.ply"
        write_ply(os.path.join(self.root, uri), positions, faces, normals, texcoords)
        self.j["shapes"].append({"name": name, "uri": uri})
        return len(self.j["shapes"]) - 1

    def instance(self, name, shape, material, frame=None) -> None:
        inst = {"name": name, "shape": int(shape), "material": int(material)}
        if frame is not None:
            inst["frame"] = [float(x) for x in np.reshape(frame, -1)]
        self.j["instances"].append(inst)

    def hdr_texture(self, name, pixels) -> int:
        os.makedirs(os.path.join(self.root, "textures"), exist_ok=True)
        uri = f"textures/{name}.hdr"
        save_hdr(os.path.join(self.root, uri), pixels)
        self.j["textures"].append({"name": name, "uri": uri})
        return len(self.j["textures"]) - 1

    def save(self, scene_name: str) -> str:
        path = os.path.join(self.root, f"{scene_name}.json")
        with open(path, "w") as f:
            json.dump(self.j, f, indent=1, sort_keys=True)
        return path


# ---------------------------------------------------------------------------
# geometry helpers


def _quad_grid(nu: int, nv: int) -> np.ndarray:
    """Triangles [2*nu*nv, 3] over an (nu+1) x (nv+1) vertex grid."""
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * (nv + 1) + j
    b = a + nv + 1
    c, d = b + 1, a + 1
    tris = np.stack([np.stack([a, b, c], -1), np.stack([c, d, a], -1)], axis=2)
    return tris.reshape(-1, 3).astype(np.int32)


def _grid_normals(pos: np.ndarray, nu: int, nv: int) -> np.ndarray:
    """Vertex normals of an (nu+1) x (nv+1) grid by central differences."""
    p = pos.reshape(nu + 1, nv + 1, 3)
    du = np.gradient(p, axis=0)
    dv = np.gradient(p, axis=1)
    n = np.cross(du, dv)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    fallback = p - p.reshape(-1, 3).mean(axis=0)
    n = np.where(ln > 1e-12, n / np.maximum(ln, 1e-12), fallback)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(ln, 1e-12)).reshape(-1, 3)


def _rotation(rng) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _displaced_shape(rng, n_tris: int):
    """A displaced, tessellated superellipsoid or torus in the unit box:
    (positions, triangles, normals, texcoords)."""
    nv = max(4, int(np.sqrt(n_tris / 4)))
    nu = max(4, n_tris // (2 * nv))
    u = np.linspace(0.0, 1.0, nu + 1)
    v = np.linspace(0.0, 1.0, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    phi = 2 * np.pi * uu
    # random low-frequency displacement field over the parameter domain
    k = rng.integers(1, 7, size=(6, 2))
    ph = rng.uniform(0, 2 * np.pi, size=6)
    amp = rng.uniform(0.0, 0.08, size=6)
    disp = sum(a * np.sin(2 * np.pi * (ku * uu + kv * vv) + p)
               for (ku, kv), p, a in zip(k, ph, amp))
    if rng.random() < 0.7:
        e1, e2 = rng.uniform(0.3, 2.0, size=2)  # superellipsoid exponents
        theta = np.pi * vv
        sgn = lambda x, e: np.sign(x) * np.abs(x) ** e
        st, ct = np.sin(theta), np.cos(theta)
        r = 1.0 + disp
        x = r * sgn(st, e1) * sgn(np.cos(phi), e2)
        y = r * sgn(ct, e1)
        z = r * sgn(st, e1) * sgn(np.sin(phi), e2)
    else:
        rmin = rng.uniform(0.15, 0.45)
        theta = 2 * np.pi * vv
        rr = 1.0 - rmin + (rmin + disp * 0.5) * np.cos(theta)
        x = rr * np.cos(phi)
        y = (rmin + disp * 0.5) * np.sin(theta)
        z = rr * np.sin(phi)
    pos = np.stack([x, y, z], -1).reshape(-1, 3)
    tris = _quad_grid(nu, nv)
    nrm = _grid_normals(pos, nu, nv)
    tc = np.stack([uu, vv], -1).reshape(-1, 2)
    return pos.astype(np.float32), tris, nrm.astype(np.float32), tc.astype(np.float32)


def _box_walls(lo, hi, n: int):
    """Inward-facing tessellated box (floor, ceiling, 4 walls) as one
    triangle mesh: (positions, triangles)."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    pos, tris = [], []
    t = np.linspace(0.0, 1.0, n + 1)
    a, b = np.meshgrid(t, t, indexing="ij")
    for axis in range(3):
        for side in (0, 1):
            u_ax, v_ax = [k for k in range(3) if k != axis]
            p = np.zeros((n + 1, n + 1, 3))
            p[..., axis] = hi[axis] if side else lo[axis]
            p[..., u_ax] = lo[u_ax] + a * (hi[u_ax] - lo[u_ax])
            p[..., v_ax] = lo[v_ax] + b * (hi[v_ax] - lo[v_ax])
            tr = _quad_grid(n, n)
            # orient every face toward the box interior
            e1 = p[1, 0] - p[0, 0]
            e2 = p[0, 1] - p[0, 0]
            inward = np.zeros(3)
            inward[axis] = -1.0 if side else 1.0
            if np.dot(np.cross(e1, e2), inward) < 0:
                tr = tr[:, ::-1]
            tris.append(tr + sum(len(q) for q in pos))
            pos.append(p.reshape(-1, 3))
    return np.concatenate(pos).astype(np.float32), np.concatenate(tris)


def _quad_light(center, size):
    """Downward-facing quad (two triangles) at `center` of side `size`."""
    cx, cy, cz = center
    h = size / 2
    pos = np.array([[cx - h, cy, cz - h], [cx + h, cy, cz - h],
                    [cx + h, cy, cz + h], [cx - h, cy, cz + h]], np.float32)
    return pos, np.array([[0, 1, 2], [2, 3, 0]], np.int32)


def _frame(rot, origin) -> np.ndarray:
    return np.concatenate([np.asarray(rot, np.float32),
                           np.asarray(origin, np.float32)[None]], axis=0)


# ---------------------------------------------------------------------------
# scenes


def _cornellbox(w: _SceneWriter, seed: int) -> None:
    del seed  # fixed geometry
    white = (0.725, 0.71, 0.68)
    shapes = {
        "backwall": ([[-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]],
                     [[0, 1, 2], [2, 3, 0]], dict(color=white)),
        "ceiling": ([[-1, 2, 1], [-1, 2, -1], [1, 2, -1], [1, 2, 1]],
                    [[0, 1, 2], [2, 3, 0]], dict(color=white)),
        "floor": ([[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]],
                  [[0, 1, 2], [2, 3, 0]], dict(color=white)),
        "leftwall": ([[-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]],
                     [[0, 1, 2], [2, 3, 0]], dict(color=(0.63, 0.065, 0.05))),
        "light": ([[-0.25, 1.99, 0.25], [0.25, 1.99, 0.25],
                   [0.25, 1.99, -0.25], [-0.25, 1.99, -0.25]],
                  [[0, 1, 2], [2, 3, 0]],
                  dict(color=(0.0, 0.0, 0.0), emission=(17.0, 12.0, 4.0))),
        "rightwall": ([[1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]],
                      [[0, 1, 2], [2, 3, 0]], dict(color=(0.14, 0.45, 0.091))),
        "shortbox": (
            [[0.53, 0.6, 0.75], [0.7, 0.6, 0.17], [0.13, 0.6, 0.0],
             [-0.05, 0.6, 0.57], [-0.05, 0.0, 0.57], [-0.05, 0.6, 0.57],
             [0.13, 0.6, 0.0], [0.13, 0.0, 0.0], [0.53, 0.0, 0.75],
             [0.53, 0.6, 0.75], [-0.05, 0.6, 0.57], [-0.05, 0.0, 0.57],
             [0.7, 0.0, 0.17], [0.7, 0.6, 0.17], [0.53, 0.6, 0.75],
             [0.53, 0.0, 0.75], [0.13, 0.0, 0.0], [0.13, 0.6, 0.0],
             [0.7, 0.6, 0.17], [0.7, 0.0, 0.17], [0.53, 0.0, 0.75],
             [0.7, 0.0, 0.17], [0.13, 0.0, 0.0], [-0.05, 0.0, 0.57]],
            [[0, 1, 2], [2, 3, 0], [4, 5, 6], [6, 7, 4], [8, 9, 10],
             [10, 11, 8], [12, 13, 14], [14, 15, 12], [16, 17, 18],
             [18, 19, 16], [20, 21, 22], [22, 23, 20]],
            dict(color=white)),
        "tallbox": (
            [[-0.53, 1.2, 0.09], [0.04, 1.2, -0.09], [-0.14, 1.2, -0.67],
             [-0.71, 1.2, -0.49], [-0.53, 0.0, 0.09], [-0.53, 1.2, 0.09],
             [-0.71, 1.2, -0.49], [-0.71, 0.0, -0.49], [-0.71, 0.0, -0.49],
             [-0.71, 1.2, -0.49], [-0.14, 1.2, -0.67], [-0.14, 0.0, -0.67],
             [-0.14, 0.0, -0.67], [-0.14, 1.2, -0.67], [0.04, 1.2, -0.09],
             [0.04, 0.0, -0.09], [0.04, 0.0, -0.09], [0.04, 1.2, -0.09],
             [-0.53, 1.2, 0.09], [-0.53, 0.0, 0.09], [-0.53, 0.0, 0.09],
             [0.04, 0.0, -0.09], [-0.14, 0.0, -0.67], [-0.71, 0.0, -0.49]],
            [[0, 1, 2], [2, 3, 0], [4, 5, 6], [6, 7, 4], [8, 9, 10],
             [10, 11, 8], [12, 13, 14], [14, 15, 12], [16, 17, 18],
             [18, 19, 16], [20, 21, 22], [22, 23, 20]],
            dict(color=white)),
    }
    w.camera("camera1", frame=_frame(np.eye(3), [0, 1, 3.9]), lens=0.035,
             film=0.024, aspect=1.0, focus=3.9, aperture=0.0)
    for name, (pos, tris, mat) in shapes.items():
        sid = w.shape(name, pos, tris)
        mid = w.material(name, type="matte", **mat)
        w.instance(name, sid, mid)


KITCHEN_SHAPES = 299  # corpus kitchen: 299 shapes, 1.44M faces
KITCHEN_TRIANGLES = 1_440_000


def _kitchen_class(w: _SceneWriter, seed: int) -> None:
    rng = np.random.default_rng(seed)
    lo, hi = np.array([-3.0, 0.0, -2.5]), np.array([3.0, 3.0, 2.5])
    w.camera("camera", lookat=[[2.6, 1.6, 2.2], [-0.5, 0.8, -0.6], [0, 1, 0]],
             lens=0.024, film=0.036, aspect=16 / 9, aperture=0.0)
    mats = []
    palette = rng.uniform(0.15, 0.85, size=(12, 3))
    for i in range(8):
        mats.append(w.material(f"matte{i}", type="matte", color=palette[i]))
    for i in range(8, 11):
        mats.append(w.material(f"glossy{i}", type="glossy", color=palette[i],
                               roughness=float(rng.uniform(0.05, 0.4))))
    glass = w.material("glass", type="refractive", color=(1.0, 1.0, 1.0),
                       roughness=0.0, ior=1.5)
    mats.append(glass)
    walls_m = w.material("walls", type="matte", color=(0.7, 0.68, 0.62))
    light_m = w.material("light", type="matte", color=(0.0, 0.0, 0.0),
                         emission=(14.0, 13.0, 11.0))
    # room shell: 6 tessellated faces, and 4 ceiling lights
    pos, tris = _box_walls(lo, hi, 24)
    w.instance("room", w.shape("room", pos, tris), walls_m)
    for k, (x, z) in enumerate([(-1.5, -1.2), (1.5, -1.2), (-1.5, 1.2), (1.5, 1.2)]):
        lp, lt = _quad_light((x, 2.98, z), 0.6)
        w.instance(f"light{k}", w.shape(f"light{k}", lp, lt), light_m)
    # the clutter: shape sizes log-uniform, rescaled to the triangle budget
    n_obj = KITCHEN_SHAPES - 5
    budget = KITCHEN_TRIANGLES - len(tris) - 8
    weights = np.exp(rng.uniform(np.log(1.0), np.log(60.0), size=n_obj))
    counts = np.maximum(64, (weights / weights.sum() * budget).astype(int))
    for k in range(n_obj):
        p, t, n, tc = _displaced_shape(rng, int(counts[k]))
        scale = np.exp(rng.uniform(np.log(0.04), np.log(0.3))) * rng.uniform(0.6, 1.4, 3)
        rot = _rotation(rng)
        # clutter sits on the floor, on a "counter" height band, or on a
        # "shelf" along the back wall, clear of the camera's corner;
        # overlaps are intended
        band = rng.integers(0, 3)
        y = [scale[1], 0.9 + scale[1], 1.7 + scale[1]][band]
        cx = rng.uniform(lo[0] + 0.4, hi[0] - 0.4)
        cz = rng.uniform(lo[2] + 0.4, hi[2] - 0.4) if band < 2 else rng.uniform(-2.4, -1.8)
        if cx > 1.2 and cz > 0.8:
            cx, cz = cx - 2.4, cz - 2.0
        lin = rot * scale[:, None]  # scaled rotation: rigid frame + scale
        p_w = p.astype(np.float64) @ lin + np.array([cx, y, cz])
        n_w = n.astype(np.float64) @ np.linalg.inv(lin).T
        n_w /= np.maximum(np.linalg.norm(n_w, axis=1, keepdims=True), 1e-12)
        sid = w.shape(f"object{k:03d}", p_w, t, n_w, tc)
        mid = glass if rng.random() < 0.06 else mats[rng.integers(0, 11)]
        w.instance(f"object{k:03d}", sid, mid)


def _envmap(w: _SceneWriter, seed: int) -> None:
    rng = np.random.default_rng(seed)
    w.camera("camera", lookat=[[0, 1.2, 4.0], [0, 0.5, 0], [0, 1, 0]],
             lens=0.035, film=0.036, aspect=1.5)
    # panorama: dim sky gradient, bright "sun" patch (values > 1)
    hh, ww = 32, 64
    v = (np.arange(hh) + 0.5) / hh
    sky = np.zeros((hh, ww, 3), np.float32)
    sky[...] = (0.4 + 0.6 * (1 - v))[:, None, None] * np.array([0.5, 0.7, 1.0])
    sky[hh // 2:] *= 0.2  # ground
    sy, sx = int(rng.integers(4, 10)), int(rng.integers(0, ww - 4))
    sky[sy:sy + 3, sx:sx + 4] = (40.0, 36.0, 30.0)
    tex = w.hdr_texture("sky", sky)
    w.j["environments"].append({"name": "sky", "emission": [0.5, 0.5, 0.5],
                                "emission_tex": tex})
    floor_p = np.array([[-4, 0, 4], [4, 0, 4], [4, 0, -4], [-4, 0, -4]], np.float32)
    fm = w.material("floor", type="matte", color=(0.6, 0.6, 0.6))
    w.instance("floor", w.shape("floor", floor_p, [[0, 1, 2], [2, 3, 0]]), fm)
    # quad-mesh UV sphere with normals and texcoords
    nu, nv = 96, 64
    uu, vv = np.meshgrid(np.linspace(0, 1, nu + 1), np.linspace(0, 1, nv + 1),
                         indexing="ij")
    th, ph = np.pi * vv, 2 * np.pi * uu
    n = np.stack([np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)], -1)
    n = n.reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * (nv + 1) + j
    quads = np.stack([a, a + 1, a + nv + 2, a + nv + 1], -1).reshape(-1, 4)
    tc = np.stack([uu, vv], -1).reshape(-1, 2)
    sm = w.material("sphere", type="glossy", color=(0.8, 0.3, 0.2), roughness=0.2)
    sid = w.shape("sphere", n * 0.5, quads, n, tc)
    w.instance("sphere", sid, sm, frame=_frame(np.eye(3), [0, 0.5, 0]))


def _manylights(w: _SceneWriter, seed: int) -> None:
    rng = np.random.default_rng(seed)
    w.camera("camera", lookat=[[0, 1.0, 3.8], [0, 0.4, 0], [0, 1, 0]],
             lens=0.03, film=0.036, aspect=1.0)
    pos, tris = _box_walls([-2, 0, -2], [2, 3, 2], 4)
    w.instance("room", w.shape("room", pos, tris),
               w.material("room", type="matte", color=(0.6, 0.6, 0.6)))
    # four layers of slats between the floor and the lights
    slat_m = w.material("slats", type="matte", color=(0.5, 0.45, 0.4))
    sp, st = [], []
    for layer, y in enumerate((0.7, 1.3, 1.9, 2.5)):
        for k in range(7):
            x0 = -1.95 + k * 0.55 + (0.2 if layer % 2 else 0.0)
            z0, z1 = -1.95, 1.2
            quad = np.array([[x0, y, z1], [x0 + 0.4, y, z1],
                             [x0 + 0.4, y, z0], [x0, y, z0]], np.float32)
            st.append(np.array([[0, 1, 2], [2, 3, 0]]) + 4 * len(sp))
            sp.append(quad)
    w.instance("slats", w.shape("slats", np.concatenate(sp), np.concatenate(st)), slat_m)
    # 13 small emitters with distinct emissions, one per cell of a 4 x 4
    # grid (no two overlap: coplanar overlapping emitters would be
    # crossed at one t)
    cells = rng.permutation(16)[:13]
    for k, cell in enumerate(cells):
        x = -1.5 + (cell % 4) + rng.uniform(-0.2, 0.2)
        z = -1.5 + (cell // 4) + rng.uniform(-0.2, 0.2)
        e = rng.uniform(4.0, 20.0, size=3)
        lp, lt = _quad_light((x, 2.95, z), float(rng.uniform(0.15, 0.35)))
        lm = w.material(f"light{k:02d}", type="matte", color=(0, 0, 0), emission=e)
        w.instance(f"light{k:02d}", w.shape(f"light{k:02d}", lp, lt), lm)


SCENES = {
    "cornellbox": _cornellbox,
    "kitchen_class": _kitchen_class,
    "envmap": _envmap,
    "manylights": _manylights,
}


def scene_path(name: str, seed: int = 0, root: str | None = None) -> str:
    root = root or SCENES_ROOT
    dirname = name if seed == 0 else f"{name}_s{seed}"
    return os.path.join(root, dirname, f"{name}.json")


def generate(name: str, seed: int = 0, root: str | None = None,
             replace: bool = True) -> str:
    """Write scene `name` for `seed`; returns its JSON path. The scene is
    written to a temporary directory and renamed into place, so a reader
    never sees a partial scene; with replace=False an existing scene (for
    instance one another process just wrote) is kept."""
    final = os.path.dirname(scene_path(name, seed, root))
    tmp = f"{final}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    writer = _SceneWriter(tmp)
    SCENES[name](writer, seed)
    writer.save(name)
    if replace:
        shutil.rmtree(final, ignore_errors=True)
    try:
        os.rename(tmp, final)
    except OSError:  # `final` exists: another process renamed its copy first
        shutil.rmtree(tmp, ignore_errors=True)
    return scene_path(name, seed, root)


def ensure_scene(name: str, seed: int = 0, root: str | None = None) -> str:
    """JSON path of scene `name`, generating it when absent."""
    path = scene_path(name, seed, root)
    if not os.path.exists(path):
        # a directory without its JSON is damaged, not a concurrent write
        # (those appear complete, by rename): replace it
        generate(name, seed, root, replace=os.path.isdir(os.path.dirname(path)))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", default=sorted(SCENES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--root", default=None, help=f"output root (default {SCENES_ROOT})")
    a = ap.parse_args(argv)
    for name in a.names:
        print(generate(name, a.seed, a.root))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Catmull-Clark subdivision tessellation (beyond reference).

The reference parses subdiv entries but never tessellates them
(src/sceneio.jl:73 "#todo(?) subdivs") — it renders the pre-tessellated
PLYs Yocto exported alongside. Here the standard Catmull-Clark scheme
(face points, interior edge points (v0+v1+f0+f1)/4, boundary-midpoint
edge points, the (Q + 2R + (n-3)P)/n interior vertex rule and the
(m0 + m1 + 6P)/8 boundary rule) is implemented vectorized in numpy,
validated against Yocto's own tessellations: subdividing
scenes/shapes2/subdivs/cubesubdiv.obj 4 levels reproduces
shapes/cubesubdiv.ply (tests/test_subdiv.py).

Applied at load when JRT_TESSELLATE=1 (the exported PLYs already hold
the subdivided meshes, so default-off keeps renders byte-comparable to
the reference corpus) or when the referenced shape's PLY is a stripped
blob and the cage OBJ survives.
"""

from __future__ import annotations

import numpy as np


def _edge_table(faces: np.ndarray, nsides: np.ndarray):
    """-> (edge_v [E,2], slot_edge [F,4] edge id per face slot (valid
    slots only), edge_face_count [E], edge_face_fp_sum via adjacency)."""
    F = len(faces)
    slots = []
    for j in range(4):
        a = faces[:, j]
        # next slot wraps at each face's own side count
        b = faces[np.arange(F), np.where(j + 1 < nsides, j + 1, 0)]
        slots.append(np.stack([a, b], axis=1))
    slot_ab = np.stack(slots, axis=1)  # [F, 4, 2]
    valid = np.arange(4)[None, :] < nsides[:, None]  # [F, 4]
    key = np.sort(slot_ab, axis=2)  # canonical (min,max)
    flat = key.reshape(-1, 2)
    valid_flat = valid.reshape(-1)
    uniq, inv = np.unique(
        flat[valid_flat], axis=0, return_inverse=True
    )
    slot_edge = np.full(F * 4, -1, np.int64)
    slot_edge[valid_flat] = inv
    return uniq, slot_edge.reshape(F, 4), valid


def catmull_clark(
    positions: np.ndarray, faces: np.ndarray, nsides: np.ndarray,
    levels: int, lock_boundary: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """levels rounds of Catmull-Clark. positions [V,D] f32 (D=3 for
    geometry, D=2 for a face-varying texcoord mesh); faces [F,4] (slot 3
    repeats slot 2 for tris); nsides [F] in {3,4}. Returns
    (positions [V',D] f32, quads [F',4] i32) — all-quads after the
    first round. The new-face emission order depends only on (faces,
    nsides) topology counts, so two attribute meshes over the same face
    list subdivide into ALIGNED quad lists. lock_boundary pins boundary
    verts to their linear-subdivision positions (used for texcoord
    meshes, whose UV-island borders must stay put — matching Yocto)."""
    pos = np.asarray(positions, np.float64)
    faces = np.asarray(faces, np.int64)
    nsides = np.asarray(nsides, np.int64)
    for _ in range(max(levels, 0)):
        V, F = len(pos), len(faces)
        edge_v, slot_edge, valid = _edge_table(faces, nsides)
        E = len(edge_v)

        # ---- 1. LINEAR midpoint subdivision ----
        D = pos.shape[1]
        fsum = np.zeros((F, D))
        for j in range(4):
            fsum += np.where(valid[:, j, None], pos[faces[:, j]], 0.0)
        face_pt = fsum / nsides[:, None]
        mid = 0.5 * (pos[edge_v[:, 0]] + pos[edge_v[:, 1]])
        lin = np.concatenate([pos, face_pt, mid], axis=0)
        NV = len(lin)

        # new faces: n quads per n-gon — (v_j, e_j, f, e_{j-1})
        fp_id = V + np.arange(F)
        ep_id = V + F + slot_edge  # [F, 4] (-1 on dead slots)
        quads = []
        for j in range(4):
            m = valid[:, j]
            prev = np.where(j == 0, nsides - 1, j - 1)
            q = np.stack(
                [
                    faces[:, j],
                    ep_id[:, j],
                    fp_id,
                    ep_id[np.arange(F), prev],
                ],
                axis=1,
            )
            quads.append(q[m])
        tquads = np.concatenate(quads, axis=0).astype(np.int64)

        # ---- 2. averaging + correction (Yocto's formulation, which
        # reproduces classic Catmull-Clark on closed meshes — validated
        # bit-exactly vs the corpus cube pre-tessellation) ----
        se = slot_edge[valid]
        e_nface = np.bincount(se, minlength=E)
        bnd = np.nonzero(e_nface == 1)[0]  # boundary edge ids (old mesh)
        is_bnd = np.zeros(NV, bool)
        is_bnd[edge_v[bnd].reshape(-1)] = True
        is_bnd[V + F + bnd] = True

        avert = np.zeros((NV, D))
        acnt = np.zeros(NV)
        # boundary pass: each old boundary edge became two sub-edges
        # (v0, m) and (m, v1); their midpoints average into both
        # (boundary) endpoints. Locked boundaries skip this, leaving
        # acnt == 0 there, and the correction below keeps `lin`
        for ends in (
            () if lock_boundary else (edge_v[bnd, 0], edge_v[bnd, 1])
        ):
            m_id = V + F + bnd
            c = 0.5 * (lin[ends] + lin[m_id])
            np.add.at(avert, ends, c)
            np.add.at(acnt, ends, 1.0)
            np.add.at(avert, m_id, c)
            np.add.at(acnt, m_id, 1.0)
        # quad pass: centroids into NON-boundary corners
        qc = lin[tquads].mean(axis=1)  # [F', 3]
        for j in range(4):
            vj = tquads[:, j]
            m = ~is_bnd[vj]
            np.add.at(avert, vj[m], qc[m])
            np.add.at(acnt, vj[m], 1.0)

        k = np.maximum(acnt, 1.0)
        avg = avert / k[:, None]
        pos = lin + (avg - lin) * (4.0 / k)[:, None] * (acnt > 0)[:, None]
        faces = tquads
        nsides = np.full(len(faces), 4, np.int64)
    return pos.astype(np.float32), faces.astype(np.int32)


def vertex_normals(positions: np.ndarray, quads: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals for an all-quad mesh."""
    p = positions.astype(np.float64)
    a, b, c, d = (p[quads[:, j]] for j in range(4))
    n = np.cross(c - a, d - b)  # quad normal (diagonal cross), area-weighted
    out = np.zeros_like(p)
    for j in range(4):
        np.add.at(out, quads[:, j], n)
    l = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.where(l > 0, l, 1.0)).astype(np.float32)


def tessellate_subdiv(obj_path: str, subdivisions: int, smooth: bool,
                      displacement: float = 0.0, disp_tex=None):
    """OBJ control cage -> (positions, quads, normals|None,
    texcoords|None).

    Face-varying texcoords (UV seams) subdivide as their OWN
    Catmull-Clark mesh over the same face list — the two aligned quad
    lists then merge into per-vertex attributes by splitting vertices at
    (position-id, texcoord-id) seams, exactly how Yocto's exported PLYs
    are laid out (cubesubdiv: 1538 geometric verts -> 1734 split verts).
    displacement + disp_tex (TextureData) displace along smooth normals
    by the texture's mean channel, Yocto displacement semantics."""
    from julia_raytracer.scene.objio import load_obj_cage

    pos, faces, nsides, uvs, vt_faces = load_obj_cage(obj_path)
    pos, quads = catmull_clark(pos, faces, nsides, subdivisions)
    # subdivisions == 0 keeps tri faces as [a,b,c,c] rows — the PLY quad
    # convention (repeated last index = triangle), directly renderable.
    # Normals come from the GEOMETRIC mesh (before any fvar split) so UV
    # seams stay smooth — seam-duplicated verts share one normal
    normals_g = vertex_normals(pos, quads) if len(quads) else None
    texcoords = None
    normals = normals_g if smooth else None
    if uvs is not None:
        uv2, uvq = catmull_clark(
            uvs, vt_faces, nsides, subdivisions, lock_boundary=True
        )
        # merge fvar: split verts at (pos_id, vt_id) seams
        pairs = np.stack([quads.reshape(-1), uvq.reshape(-1)], axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        quads = inv.astype(np.int32).reshape(-1, 4)
        pos = pos[uniq[:, 0]]
        texcoords = uv2[uniq[:, 1]].astype(np.float32)
        # OBJ vt -> the pipeline's internal (PLY-load) convention:
        # flipped v (src/shape.jl:233-234)
        texcoords[:, 1] = 1.0 - texcoords[:, 1]
        if normals_g is not None:
            normals_g = normals_g[uniq[:, 0]]
            normals = normals_g if smooth else None
    if displacement != 0.0 and disp_tex is not None and texcoords is not None:
        h = _sample_tex_mean(disp_tex, texcoords)
        pos = pos + normals_g * (displacement * h)[:, None]
        normals = vertex_normals(pos, quads) if smooth else None
    return pos, quads, normals, texcoords


def _sample_tex_mean(tex, uv: np.ndarray) -> np.ndarray:
    """Bilinear mean-RGB height lookup at INTERNAL-convention uv
    (mod-1 wrap, matching ops/texture.py; raw stored values — Yocto
    displacement semantics)."""
    w, h = tex.width, tex.height
    px = tex.pixels.reshape(h, w, 4)[..., :3].mean(axis=-1)
    u = np.mod(uv[:, 0], 1.0) * w - 0.5
    v = np.mod(uv[:, 1], 1.0) * h - 0.5
    x0 = np.floor(u).astype(np.int64)
    y0 = np.floor(v).astype(np.int64)
    fu, fv = u - x0, v - y0
    x0m, x1m = x0 % w, (x0 + 1) % w
    y0m, y1m = y0 % h, (y0 + 1) % h
    return (
        px[y0m, x0m] * (1 - fu) * (1 - fv)
        + px[y0m, x1m] * fu * (1 - fv)
        + px[y1m, x0m] * (1 - fu) * fv
        + px[y1m, x1m] * fu * fv
    ).astype(np.float32)

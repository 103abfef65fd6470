"""Host preprocessing disk cache.

Heavy scenes (kitchen class: 1.44M prims) pay seconds of host-side
numpy work (flatten, BVH, light tables) before the first ray;
the reference pays an analogous per-run BVH build cost (src/bvh.jl:66-88)
but has nothing to cache it with. Products are keyed by a content hash of
the scene's files, so edits invalidate naturally.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

_ENV = "JRT_CACHE_DIR"

# Bump when the LAYOUT of any cached product changes (prim order, BVH
# node format, light tables, ...) — scene content alone can't
# see builder-logic changes, and a stale product would be silently wrong.
BUILDER_VERSION = "v3"


def cache_dir() -> str:
    """JRT_CACHE_DIR, or <checkout>/.scene_cache."""
    d = os.environ.get(_ENV)
    if not d:
        d = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".scene_cache")
    os.makedirs(d, exist_ok=True)
    return d


def scene_cache_key(scene_path: str, *extra: str) -> str:
    """Content key: sha1 over the scene JSON bytes plus (name, size,
    mtime_ns) of every file under the scene directory, plus any extra
    tokens (e.g. 'sah' for the high-quality BVH)."""
    h = hashlib.sha1()
    try:
        with open(scene_path, "rb") as f:
            h.update(f.read())
    except OSError:
        return ""
    root = os.path.dirname(os.path.abspath(scene_path))
    entries = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in filenames:
            p = os.path.join(dirpath, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((os.path.relpath(p, root), st.st_size, st.st_mtime_ns))
    for e in sorted(entries):
        h.update(repr(e).encode())
    for e in extra:
        h.update(e.encode())
    h.update(BUILDER_VERSION.encode())
    return h.hexdigest()[:20]


def load_arrays(key: str, tag: str) -> dict | None:
    if not key:
        return None
    path = os.path.join(cache_dir(), f"{key}_{tag}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        return None


def save_arrays(key: str, tag: str, arrays: dict) -> None:
    if not key:
        return
    path = os.path.join(cache_dir(), f"{key}_{tag}.npz")
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.remove(tmp)

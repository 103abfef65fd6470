"""Host-side image IO: PNG (LDR, sRGB) and Radiance HDR (linear).

Replaces the reference's Images/FileIO usage (src/scene.jl:164-189,
src/sceneio.jl:585-611). Note the reference's HDR path is known-broken
(values clamped to [0,1], report §Results); we load HDR correctly.

Written with numpy and the standard library (zlib, struct) only:
- PNG read: 8- and 16-bit gray, gray+alpha, RGB, RGBA and 8-bit palette
  images, non-interlaced, every filter type (None, Sub, Up, Average,
  Paeth). PNG write: 8-bit RGBA, filter None.
- Radiance .hdr read: flat and run-length-encoded (new-style) RGBE
  scanlines. Write: run-length-encoded RGBE.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from julia_raytracer.utils.color import float_to_byte, rgb_to_srgb

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples/pixel


def _png_chunks(data: bytes):
    if data[:8] != _PNG_SIG:
        raise IOError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        yield ctype, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IEND":
            return


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters. raw: uint8 [height*(1+stride)]."""
    rows = raw.reshape(height, 1 + stride)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: running sum per byte lane, mod 256
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            cur = line.copy()
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
        else:
            raise IOError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def load_png_rgba(path: str) -> np.ndarray:
    """PNG -> uint8 [H, W, 4] (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    idat, palette, trns, hdr = [], None, None, None
    for ctype, body in _png_chunks(data):
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif ctype == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise IOError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _comp, _filt, interlace = hdr
    if interlace:
        raise IOError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (8, 16) or (ctype == 3 and depth != 8):
        raise IOError(f"{path}: unsupported PNG (color type {ctype}, depth {depth})")
    ch = _CHANNELS[ctype]
    bps = depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, height, width * ch * bps, ch * bps)
    if bps == 2:  # big-endian 16-bit samples -> 8-bit
        px = (px.reshape(height, -1, 2).astype(np.uint16) @ np.array([256, 1], np.uint16))
        px = (px.astype(np.uint32) * 255 + 32767) // 65535
    px = px.reshape(height, width, ch).astype(np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    out[..., 3] = 255
    if ctype == 0:
        out[..., :3] = px
    elif ctype == 2:
        out[..., :3] = px
    elif ctype == 3:
        idx = px[..., 0]
        out[..., :3] = palette[idx]
        if trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[: len(trns)] = trns
            out[..., 3] = alpha[idx]
    elif ctype == 4:
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    else:
        out[:] = px
    return out


def write_png_rgba(path: str, data: np.ndarray) -> None:
    """uint8 [H, W, 4] -> 8-bit RGBA PNG (filter None on every row)."""
    data = np.ascontiguousarray(data, np.uint8)
    h, w = data.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), data.reshape(h, w * 4)], axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(ctype + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + ctype + body + struct.pack(">I", crc)

    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """uint8 [..., 4] RGBE -> float32 [..., 3] (mantissa * 2^(e-136))."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def load_hdr_rgba(path: str) -> np.ndarray:
    """Radiance .hdr -> float32 [H, W, 4] (linear, alpha=1)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    fmt = None
    while True:  # header: lines up to the first empty one
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT="):
            fmt = line[7:]
    if fmt not in (None, b"32-bit_rle_rgbe"):
        raise IOError(f"{path}: unsupported HDR format {fmt!r}")
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise IOError(f"{path}: unsupported HDR orientation {res!r}")
    height, width = int(res[1]), int(res[3])
    buf = np.frombuffer(data, np.uint8)
    out = np.empty((height, width, 4), np.uint8)
    for y in range(height):
        if (8 <= width < 32768 and pos + 4 <= len(buf) and buf[pos] == 2
                and buf[pos + 1] == 2 and (buf[pos + 2] << 8 | buf[pos + 3]) == width):
            pos += 4
            for c in range(4):  # each component run-length encoded in turn
                x = 0
                while x < width:
                    count = int(buf[pos])
                    if count > 128:
                        count -= 128
                        out[y, x:x + count, c] = buf[pos + 1]
                        pos += 2
                    else:
                        out[y, x:x + count, c] = buf[pos + 1:pos + 1 + count]
                        pos += 1 + count
                    x += count
        else:
            out[y] = buf[pos:pos + 4 * width].reshape(width, 4)
            pos += 4 * width
    rgb = _rgbe_to_float(out)
    return np.concatenate([rgb, np.ones((height, width, 1), np.float32)], axis=-1)


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    v = np.max(rgb, axis=-1)
    mant, exp = np.frexp(v)
    scale = np.where(v > 1e-32, mant * 256.0 / np.maximum(v, 1e-32), 0.0)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v > 1e-32, exp + 128, 0).astype(np.uint8)
    return out


def _rle_component(vals: np.ndarray) -> bytes:
    """New-style Radiance RLE of one component of one scanline: runs of
    4+ equal bytes as (128+n, v), everything else as literal blocks."""
    out = bytearray()
    n, i, lit = len(vals), 0, []
    while i < n:
        j = i
        while j < n and j - i < 127 and vals[j] == vals[i]:
            j += 1
        if j - i >= 4:
            while lit:
                out += bytes([len(lit[:128])]) + bytes(lit[:128])
                lit = lit[128:]
            out += bytes([128 + j - i, int(vals[i])])
            i = j
        else:
            lit.append(int(vals[i]))
            i += 1
    while lit:
        out += bytes([len(lit[:128])]) + bytes(lit[:128])
        lit = lit[128:]
    return bytes(out)


def save_hdr(path: str, pixels: np.ndarray) -> None:
    """float [H, W, 3|4] linear -> Radiance .hdr with RLE scanlines."""
    rgbe = _float_to_rgbe(np.maximum(np.asarray(pixels, np.float32)[..., :3], 0.0))
    h, w = rgbe.shape[:2]
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        for y in range(h):
            f.write(bytes([2, 2, w >> 8, w & 0xFF]))
            for c in range(4):
                f.write(_rle_component(rgbe[y, :, c]))


def save_png(path: str, pixels: np.ndarray, linear: bool = True) -> None:
    """Save float [H, W, 4] to PNG; linear data is sRGB-encoded first.

    Mirrors save_image + to_srgb + clamp01nan (src/sceneio.jl:585-611).
    """
    pix = np.asarray(pixels, dtype=np.float32)
    pix = np.where(np.isfinite(pix), pix, 0.0)
    if linear:
        pix = rgb_to_srgb(pix)
        pix = np.clip(pix, 0.0, 1.0)
        data = np.clip(np.rint(pix * 255.0), 0, 255).astype(np.uint8)
    else:
        data = np.asarray(float_to_byte(pix))
    write_png_rgba(path, data)

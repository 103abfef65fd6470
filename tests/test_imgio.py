"""PNG and Radiance HDR IO written with numpy and the standard library
(utils/imgio.py): round trips, and agreement with PIL and OpenCV where
those are installed."""

import numpy as np
import pytest

from julia_raytracer.utils import imgio


def test_png_roundtrip(tmp_path, rng):
    a = rng.integers(0, 256, (37, 53, 4), dtype=np.uint8)
    imgio.write_png_rgba(str(tmp_path / "a.png"), a)
    np.testing.assert_array_equal(imgio.load_png_rgba(str(tmp_path / "a.png")), a)


def test_save_png_encodes_srgb(tmp_path):
    lin = np.zeros((2, 3, 4), np.float32)
    lin[..., 3] = 1.0
    lin[0, 0, :3] = 1.0
    lin[0, 1, :3] = 0.214  # sRGB ~0.5
    lin[1, 2, :3] = np.nan  # non-finite pixels write as 0
    imgio.save_png(str(tmp_path / "s.png"), lin, linear=True)
    got = imgio.load_png_rgba(str(tmp_path / "s.png"))
    assert got[0, 0, 0] == 255 and got[1, 2, 0] == 0 and got[1, 0, 0] == 0
    assert abs(int(got[0, 1, 1]) - 128) <= 1
    assert (got[..., 3] == 255).all()


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA", "P"])
def test_png_read_matches_pil(tmp_path, rng, mode):
    Image = pytest.importorskip("PIL.Image")
    # a smooth image makes the encoder use Sub/Up/Average/Paeth filters
    y, x = np.mgrid[0:48, 0:64]
    img = np.stack([x * 4, y * 5, (x + y) * 2, 255 - x], -1).astype(np.uint8)
    img[::7, ::5] = rng.integers(0, 256, img[::7, ::5].shape, dtype=np.uint8)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img, "RGBA").convert(mode).save(path, optimize=True)
    want = np.asarray(Image.open(path).convert("RGBA"))
    np.testing.assert_array_equal(imgio.load_png_rgba(path), want)


def test_png_16bit_matches_cv2(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    a = rng.integers(0, 65536, (20, 30, 3)).astype(np.uint16)
    path = str(tmp_path / "d16.png")
    cv2.imwrite(path, a)
    want = np.round(cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1] / 257.0)
    np.testing.assert_array_equal(imgio.load_png_rgba(path)[..., :3], want)


def _hdr_pixels(rng):
    h = (rng.random((33, 41, 3)) * rng.choice([0.01, 1.0, 100.0], (33, 41, 3)))
    h[:, :20] = h[:1, :1]  # long runs, so the RLE writes run packets
    return h.astype(np.float32)


def test_hdr_roundtrip(tmp_path, rng):
    h = _hdr_pixels(rng)
    imgio.save_hdr(str(tmp_path / "a.hdr"), h)
    got = imgio.load_hdr_rgba(str(tmp_path / "a.hdr"))
    assert got.shape == (33, 41, 4) and (got[..., 3] == 1).all()
    # RGBE keeps 8 mantissa bits of each pixel's largest channel
    err = np.abs(got[..., :3] - h) / h.max(axis=-1, keepdims=True)
    assert err.max() < 1 / 128


def test_hdr_matches_cv2(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    h = _hdr_pixels(rng)
    cv2.imwrite(str(tmp_path / "cv.hdr"), h[..., ::-1])
    want = cv2.imread(str(tmp_path / "cv.hdr"), cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(imgio.load_hdr_rgba(str(tmp_path / "cv.hdr"))[..., :3], want)
    # and OpenCV reads what save_hdr writes
    imgio.save_hdr(str(tmp_path / "own.hdr"), h)
    back = cv2.imread(str(tmp_path / "own.hdr"), cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(imgio.load_hdr_rgba(str(tmp_path / "own.hdr"))[..., :3], back)

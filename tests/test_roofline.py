"""Peak table (utils/roofline.py): known devices only."""

import pytest

from julia_raytracer.utils.roofline import PEAKS, device_peaks


def test_h100_peaks():
    p = device_peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12 and p["fp32_flops"] == 67e12
    assert all(v["source"] for v in PEAKS.values())


def test_unknown_device_is_an_error():
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("cpu")
    with pytest.raises(KeyError):
        device_peaks("some other card")

"""Published device peaks, the denominators of a roofline share.

The peaks live in one table keyed by `jax.Device.device_kind`. A device
that is not in the table is an error: no peak is assumed for hardware
this module does not know. The numerators (flops and bytes a render
moved) must come from a device trace: XLA's cost analysis cannot see
inside the Pallas kernel and counts each while_loop body once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit: float32 outside the tensor cores, TF32 and bf16 in
# them, and HBM3 bandwidth.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet (dense, 700 W)",
    },
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of `device_kind`; KeyError for an unknown device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add them "
            "to julia_raytracer.utils.roofline.PEAKS with their source"
        ) from None

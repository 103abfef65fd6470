"""Wall-clock formatting for the progress/ETC UX (reference: src/utils.jl:10-32)."""

from __future__ import annotations


def format_seconds(seconds: float) -> str:
    """h:mm:ss.mmm, matching the reference CLI output format."""
    if seconds != seconds or seconds < 0:  # NaN / negative guard
        seconds = 0.0
    total_ms = int(round(seconds * 1000))
    ms = total_ms % 1000
    total_s = total_ms // 1000
    s = total_s % 60
    m = (total_s // 60) % 60
    h = total_s // 3600
    return f"{h}:{m:02d}:{s:02d}.{ms:03d}"

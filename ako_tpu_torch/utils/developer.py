"""Plane-dump helper for debugging the coefficient pipeline: a copy of
ako_tpu/utils/developer.py (numpy only).

Rebuild of akoSavePgmI16 (reference library/developer.c:29-48): write
an int16 plane as a binary 8-bit PGM, clamping each value to [0, 255]
as the reference's nested ternary does (developer.c:40)."""

from __future__ import annotations

import numpy as np


def save_pgm_i16(plane: np.ndarray, filename: str) -> None:
    """plane: (h, w) int16. Values are clamped to [0, 255], the
    reference's saturation."""
    plane = np.asarray(plane, dtype=np.int16)
    if plane.ndim != 2 or plane.size == 0:
        raise ValueError("expected a non-empty (h, w) int16 plane")
    h, w = plane.shape
    data = np.clip(plane, 0, 255).astype(np.uint8)
    with open(filename, "wb") as f:
        f.write(b"P5\n%d\n%d\n255\n" % (w, h))
        f.write(data.tobytes())

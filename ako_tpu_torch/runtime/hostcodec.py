"""One-call native tile codecs (akort.c): format + lift + Kagari for a
whole tile in one C call, and the inverse.

They share no code with the port's device path (torch ops and the CUDA
lift kernels), so they are its independent oracle where there is no
JAX: `chip_smoke.py` frames their payloads into blobs and holds the
port's `encode`/`decode` to them byte for byte and pixel for pixel.
"""

from __future__ import annotations

import numpy as np

from ako_tpu_torch.core import geometry
from ako_tpu_torch.core.settings import AkoError, Color, Status, Wavelet, Wrap
from ako_tpu_torch.runtime.build import load


def _flat_qg(qg):
    qs = np.ascontiguousarray([q for level_qs, _ in qg for q in level_qs], dtype=np.int32)
    gs = np.ascontiguousarray([g for _, level_gs in qg for g in level_gs], dtype=np.int32)
    return qs, gs


def tile_encode_block(
    tile_u8: np.ndarray,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
    qg,
    output_capacity: int,
    discard_non_visible: bool = False,
) -> bytes | None:
    """Interleaved u8 tile (h, w, channels) -> Kagari payload (no frame
    head) in one native call (akort_tile_encode_block). `qg` is
    level_qg's output. None when incompressible."""
    if output_capacity <= 0:
        return None
    lib = load()
    tile_u8 = np.ascontiguousarray(tile_u8, dtype=np.uint8)
    h, w, channels = tile_u8.shape
    if wavelet == Wavelet.NONE:
        count = w * h * channels
    else:
        count = geometry.tile_data_size(w, h) * channels // 2
    out = np.empty(output_capacity, dtype=np.uint8)
    qs, gs = _flat_qg(qg)
    rc = np.zeros(1, dtype=np.int32)
    n = lib.akort_tile_encode_block(
        tile_u8.ctypes.data,
        w,
        h,
        channels,
        int(wavelet),
        int(wrap),
        int(color),
        1 if discard_non_visible else 0,
        qs.ctypes.data if qs.size else None,
        gs.ctypes.data if gs.size else None,
        count,
        out.ctypes.data,
        output_capacity,
        rc.ctypes.data,
    )
    if n == 0:
        if int(rc[0]) not in (0, 1):
            raise AkoError(Status.ERROR, f"native tile encode rc={int(rc[0])}")
        return None
    return out[:n].tobytes()


def tile_decode_block(
    payload,
    count: int,
    output_capacity_bytes: int,
    tile_w: int,
    tile_h: int,
    channels: int,
    wavelet: Wavelet,
    wrap: Wrap,
    color: Color,
) -> np.ndarray | None:
    """Kagari payload -> interleaved u8 pixels (tile_h, tile_w,
    channels) in one native call (entropy + unlift + inverse color;
    akort_tile_decode_block). None on broken input."""
    lib = load()
    src = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty((tile_h, tile_w, channels), dtype=np.uint8)
    rc = lib.akort_tile_decode_block(
        src.ctypes.data if src.size else None,
        src.nbytes,
        count,
        output_capacity_bytes,
        tile_w,
        tile_h,
        channels,
        int(wavelet),
        int(wrap),
        int(color),
        out.ctypes.data,
    )
    if rc == 1:
        return None
    if rc != 0:
        raise AkoError(Status.ERROR, f"native tile decode rc={rc}")
    return out

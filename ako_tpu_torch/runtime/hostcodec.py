"""Native tile codecs (akort.c): the colour transform, the lift and its
inverse one tile at a time (u8_to_planes, tile_lift, tile_unlift,
planes_to_u8), and format + lift + Kagari for a whole tile in one C call
and the inverse (tile_encode_block, tile_decode_block).

They share no code with the port's device path (the CUDA kernels and
their plain torch versions), so they are its independent oracle where
there is no JAX: `chip_smoke.py` frames their payloads into blobs and
holds the port's `encode`/`decode` to them byte for byte and pixel for
pixel. The per-tile functions also carry the all-native modes
AKO_TPU_ENCODE=host and AKO_TPU_DECODE=host (encode.py, decode.py) and
the native stream of a tile the device-entropy encoder hands back to the
host coder.
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


def u8_to_planes(tile_u8: np.ndarray, color: Color, discard_non_visible: bool) -> np.ndarray:
    """Interleaved u8 (h, w, channels) -> planar int16 (channels, h, w)
    with the forward colour transform (ops/colorspace.py to_planar_yuv)."""
    lib = load()
    tile_u8 = np.ascontiguousarray(tile_u8, dtype=np.uint8)
    h, w, channels = tile_u8.shape
    out = np.empty((channels, h, w), dtype=np.int16)
    lib.akort_u8_to_planes(tile_u8.ctypes.data, w, h, channels, int(color),
                           1 if discard_non_visible else 0, out.ctypes.data)
    return out


def tile_lift(planes: np.ndarray, wavelet: Wavelet, wrap: Wrap, qg) -> np.ndarray:
    """Planar int16 (channels, th, tw) -> serialized coefficient stream
    with quantize/gate; `qg` is level_qg's output."""
    lib = load()
    planes = np.ascontiguousarray(planes, dtype=np.int16)
    channels, th, tw = planes.shape
    out = np.empty(geometry.tile_data_size(tw, th) * channels // 2, dtype=np.int16)
    qs, gs = _flat_qg(qg)
    rc = lib.akort_tile_lift(planes.ctypes.data, tw, th, channels, int(wavelet), int(wrap),
                             qs.ctypes.data if qs.size else None,
                             gs.ctypes.data if gs.size else None, out.ctypes.data, out.size)
    if rc != 0:
        raise AkoError(Status.ERROR, f"native tile lift failed (rc={rc})")
    return out


def tile_unlift(values: np.ndarray, tile_w: int, tile_h: int, channels: int, wavelet: Wavelet,
                wrap: Wrap) -> np.ndarray:
    """Serialized int16 stream -> planar int16 (channels, tile_h,
    tile_w), the inverse of tile_lift. Raises AkoError on a size
    mismatch (the tile's geometry fixes the stream's length)."""
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.int16)
    out = np.empty((channels, tile_h, tile_w), dtype=np.int16)
    rc = lib.akort_tile_unlift(values.ctypes.data, values.size, tile_w, tile_h, channels,
                               int(wavelet), int(wrap), out.ctypes.data)
    if rc != 0:
        raise AkoError(Status.ERROR, f"native tile unlift failed (rc={rc})")
    return out


def planes_to_u8(planes: np.ndarray, color: Color) -> np.ndarray:
    """Planar int16 (channels, h, w) -> interleaved u8 (h, w, channels)
    with the inverse colour transform and saturation."""
    lib = load()
    planes = np.ascontiguousarray(planes, dtype=np.int16)
    channels, h, w = planes.shape
    out = np.empty((h, w, channels), dtype=np.uint8)
    lib.akort_planes_to_u8(planes.ctypes.data, w, h, channels, int(color), out.ctypes.data)
    return out


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

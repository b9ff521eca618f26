"""Native tile codecs (akort.c): the colour transform, the lift and its
inverse one tile at a time (u8_to_planes, tile_lift, tile_unlift,
planes_to_u8), format + lift + Kagari for a whole tile in one C call
and the inverse (tile_encode_block, tile_decode_block), and the same for
a span of tiles of one image in one C call (tile_encode_spans,
tile_decode_spans: the executor's AKO_TPU_ENCODE=host and
AKO_TPU_DECODE=host routes, ako_tpu/runtime/hostcodec.py:258, :307).

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


def _check_span_arrays(n: int, **arrays) -> None:
    """The span calls read n entries (rects: n x 4) of each array through
    raw pointers: check dtype, contiguity and length first."""
    for name, (a, dtype, size) in arrays.items():
        if a.dtype != dtype or not a.flags.c_contiguous or a.size < size:
            raise ValueError(f"span call: {name} must be contiguous {np.dtype(dtype)} with at "
                             f"least {size} entries, got {a.dtype} {a.shape}")


def _check_rects(rects: np.ndarray, image: np.ndarray, name: str) -> None:
    r = rects.reshape(-1, 4)
    h, w = image.shape[:2]
    if len(r) and ((r < 0).any() or (r[:, 0] + r[:, 2]).max() > w or (r[:, 1] + r[:, 3]).max() > h):
        raise ValueError(f"{name}: a rect lies outside the {w}x{h} image")


def tile_encode_spans(image: np.ndarray, rects: np.ndarray, qg_off: np.ndarray, qs: np.ndarray,
                      gs: np.ndarray, counts: np.ndarray, caps: np.ndarray, out: np.ndarray,
                      out_off: np.ndarray, sizes: np.ndarray, wavelet: Wavelet, wrap: Wrap,
                      color: Color, discard_non_visible: bool = False) -> None:
    """Encode a span of tiles in one native call (akort_tile_encode_spans):
    the C side cuts each rect (x, y, w, h) out of the interleaved u8
    image, runs format + lift + Kagari, and writes the framed block (the
    4-byte head and the payload) at out[out_off[i]], with the payload's
    bytes in sizes[i] (0: incompressible at caps[i]). The per-tile
    arrays come from encode.host_span_plan; callers pass row slices of
    them to split one image over worker threads (the call runs without
    the GIL). Byte-identical to per-tile tile_encode_block calls."""
    n = rects.shape[0]
    if image.dtype != np.uint8 or image.ndim != 3 or image.strides[1:] != (image.shape[2], 1):
        raise ValueError("tile_encode_spans: expected a uint8 (h, w, channels) image with "
                         "contiguous rows")
    _check_span_arrays(n, rects=(rects, np.int32, 4 * n), qg_off=(qg_off, np.int64, n),
                       counts=(counts, np.int64, n), caps=(caps, np.int64, n),
                       out_off=(out_off, np.int64, n), sizes=(sizes, np.int64, n),
                       qs=(qs, np.int32, 0), gs=(gs, np.int32, 0), out=(out, np.uint8, 0))
    _check_rects(rects, image, "tile_encode_spans")
    if n and int((out_off + caps).max()) + 4 > out.size:
        raise ValueError("tile_encode_spans: a block region runs past the out buffer")
    rc = load().akort_tile_encode_spans(
        image.ctypes.data, image.strides[0], image.shape[2], int(wavelet), int(wrap), int(color),
        1 if discard_non_visible else 0, n, rects.ctypes.data, qg_off.ctypes.data,
        qs.ctypes.data if qs.size else None, gs.ctypes.data if gs.size else None,
        counts.ctypes.data, caps.ctypes.data, out.ctypes.data, out_off.ctypes.data,
        sizes.ctypes.data,
    )
    if rc != 0:
        raise AkoError(Status.ERROR, f"native span encode rc={rc}")


def tile_decode_spans(blob: np.ndarray, pay_off: np.ndarray, pay_size: np.ndarray,
                      counts: np.ndarray, caps: np.ndarray, rects: np.ndarray,
                      image_out: np.ndarray, wavelet: Wavelet, wrap: Wrap, color: Color) -> int:
    """Decode a span of tiles in one native call (akort_tile_decode_spans):
    each payload at blob[pay_off[i]] (pay_size[i] bytes) is entropy-
    decoded, unlifted and colour-inverted straight into the interleaved
    u8 image at its rect; spans over disjoint rects may run at once on
    the same image. Returns 0, or the 1-based index in this span of the
    first broken tile; raises on an allocation failure."""
    n = rects.shape[0]
    if (image_out.dtype != np.uint8 or image_out.ndim != 3
            or image_out.strides[1:] != (image_out.shape[2], 1)):
        raise ValueError("tile_decode_spans: expected a uint8 (h, w, channels) image with "
                         "contiguous rows")
    _check_span_arrays(n, rects=(rects, np.int32, 4 * n), pay_off=(pay_off, np.int64, n),
                       pay_size=(pay_size, np.int64, n), counts=(counts, np.int64, n),
                       caps=(caps, np.int64, n), blob=(blob, np.uint8, 0))
    _check_rects(rects, image_out, "tile_decode_spans")
    if n and int((pay_off + pay_size).max()) > blob.size:
        raise ValueError("tile_decode_spans: a payload runs past the blob")
    rc = load().akort_tile_decode_spans(
        blob.ctypes.data, pay_off.ctypes.data, pay_size.ctypes.data, counts.ctypes.data,
        caps.ctypes.data, n, rects.ctypes.data, image_out.strides[0], image_out.shape[2],
        int(wavelet), int(wrap), int(color), image_out.ctypes.data,
    )
    if rc == -2:
        raise AkoError(Status.ERROR, "native span decode: allocation failure")
    return rc

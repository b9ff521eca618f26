"""Decode orchestrator: .ako blob -> image.

The path of ako_tpu's decode with device_entropy=False
(ako_tpu/decode.py:1015-1043): the host parses the container and
entropy-decodes every tile block into its int16 coefficient stream
(akort.c); per tile-shape group the streams go to the device once, the
dequantize, the unlift and the inverse colour transform run there, and
the (T, h, w, C) u8 tiles come back once for placement. Pixels are
bit-identical to ako_tpu's and the reference decoder's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ako_tpu_torch.core import container, geometry
from ako_tpu_torch.core.events import Event, EventsCallback, fire
from ako_tpu_torch.core.settings import AkoError, Compression, Settings, Status, Wavelet
from ako_tpu_torch.encode import resolve_device, tile_stream_bytes
from ako_tpu_torch.ops.colorspace import to_interleaved_u8
from ako_tpu_torch.ops.lifting import inverse_tile
from ako_tpu_torch.runtime.kagari import decompress_block

#: Upper bound on decoded image bytes (w*h*channels). The reference
#: relies on malloc failing for absurd headers (status
#: NO_ENOUGH_MEMORY, encode.c:94-98); reject them before allocating.
MAX_IMAGE_BYTES = 1 << 31


def _check_decode_budget(image_w: int, image_h: int, channels: int) -> None:
    if image_w * image_h * channels > MAX_IMAGE_BYTES:
        raise AkoError(Status.NO_ENOUGH_MEMORY, "image exceeds MAX_IMAGE_BYTES")


def tile_block_sizes(t, s: Settings, channels: int):
    """(tile_data_size bytes, planes_spacing elements) for one tile —
    the decode-side size contract (reference decode.c:133-142)."""
    spacing = geometry.planes_spacing(t.w, t.h) if s.wavelet != Wavelet.NONE else 0
    return tile_stream_bytes(t, s, channels), spacing


def read_tile_stream(view, cursor: int, t, s: Settings, channels: int):
    """Entropy-decode (or raw-copy) one tile block from `view` at
    `cursor`; returns (int16 values, new_cursor). Raises
    AkoError(BROKEN_INPUT) on truncation/corruption."""
    tds, spacing = tile_block_sizes(t, s, channels)
    if s.compression != Compression.NONE:
        res = decompress_block(view[cursor:], tds, tds + spacing, s.compression)
        if res is None:
            raise AkoError(Status.BROKEN_INPUT)
        values, consumed = res
        return values, cursor + consumed
    if cursor + tds > len(view):
        raise AkoError(Status.BROKEN_INPUT)
    values = np.frombuffer(view[cursor : cursor + tds], dtype=np.int16).copy()
    return values, cursor + tds


def decode_tiles_device(streams, tw: int, th: int, channels: int, s: Settings,
                        device: torch.device) -> np.ndarray:
    """(T, coeff_count) int16 streams -> (T, th, tw, channels) u8 tiles:
    one upload, the unlift and inverse colour on `device`, one download."""
    coeffs = torch.from_numpy(streams).to(device)
    if s.wavelet == Wavelet.NONE:
        planes = coeffs.reshape(coeffs.shape[:-1] + (channels, th, tw))
    else:
        schedule = geometry.lift_schedule(tw, th)
        planes = inverse_tile(coeffs, schedule, s.wavelet, s.wrap, channels)
    # interleave on the device: placing channel-strided tiles on the host
    # costs more than the transpose
    return to_interleaved_u8(planes, s.color, channels).contiguous().cpu().numpy()


def decode(
    blob: bytes,
    events: Optional[EventsCallback] = None,
    events_user=None,
    device=None,
) -> Tuple[np.ndarray, Settings, int]:
    """Decode an .ako blob. Returns (image uint8 (h, w, channels),
    settings-from-header, channels); raises AkoError on failure.
    `device` as for encode: None means the CUDA card, "cpu" the plain
    torch path."""
    if blob is None:
        raise AkoError(Status.INVALID_INPUT)
    dev = resolve_device(device)
    view = memoryview(blob)
    channels, image_w, image_h, s = container.head_read(view)
    _check_decode_budget(image_w, image_h, channels)
    cursor = container.HEAD_SIZE

    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)

    # Host: entropy-decode every tile block into its coefficient stream
    streams: list = []
    for t in grid:
        fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        values, cursor = read_tile_stream(view, cursor, t, s, channels)
        fire(events, t.index, total, Event.COMPRESSION_END, events_user)
        streams.append(values)

    # Device: batched unlift + format per tile shape
    image = np.empty((image_h, image_w, channels), dtype=np.uint8)
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        t0 = tiles[0].index
        fire(events, t0, total, Event.WAVELET_START, events_user)
        batch = np.stack([streams[t.index] for t in tiles], axis=0)
        pix = decode_tiles_device(batch, tw, th, channels, s, dev)
        fire(events, t0, total, Event.WAVELET_END, events_user)
        fire(events, t0, total, Event.FORMAT_START, events_user)
        for i, t in enumerate(tiles):
            image[t.y : t.y + th, t.x : t.x + tw, :] = pix[i]
        fire(events, t0, total, Event.FORMAT_END, events_user)

    return image, s, channels

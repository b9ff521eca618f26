"""Encode orchestrator: image -> .ako blob.

The path of ako_tpu's encode with device_entropy=False
(ako_tpu/encode.py:333-375 then :983-1003): per tile-shape group, the
tiles go to the device once as (T, h, w, C) u8, the colour transform,
the lift with quantization and gate run there, and the (T,
coeff_count) int16 streams come back once; the host Kagari coder
(akort.c) then compresses each tile and the container is assembled on
the host. Blob bytes are identical to ako_tpu's and the reference
encoder's for every settings combination.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ako_tpu_torch.core import container, geometry
from ako_tpu_torch.core.events import Event, EventsCallback, fire
from ako_tpu_torch.core.settings import (
    AkoError,
    Color,
    Compression,
    Settings,
    Status,
    Wavelet,
    default_settings,
)
from ako_tpu_torch.ops.colorspace import to_planar_yuv
from ako_tpu_torch.ops.lifting import forward_tile
from ako_tpu_torch.ops.quantization import level_qg
from ako_tpu_torch.runtime.kagari import compress_block, effective_method


def resolve_device(device) -> torch.device:
    """`None` means the CUDA card; there is no silent CPU fallback. The
    plain torch path runs only when the caller asks for device="cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain torch path")
    return dev


def checked_settings(s: Optional[Settings]) -> Settings:
    """YCoCg auto-switches to the x2-premultiplied variant when lossy
    (encode.c:60-64)."""
    s = default_settings() if s is None else s
    if s.color == Color.YCOCG and (s.quantization > 0 or s.gate > 0):
        s = s.replace(color=Color.YCOCG_Q)
    elif s.color == Color.YCOCG_Q and (s.quantization <= 0 and s.gate <= 0):
        s = s.replace(color=Color.YCOCG)
    return s


@functools.lru_cache(maxsize=256)
def tile_qg(tile_w: int, tile_h: int, channels: int, quantization: int, gate: int,
            chroma_loss: int):
    """Per-tile-shape quantization/gate table (level_qg), cached."""
    schedule = geometry.lift_schedule(tile_w, tile_h)
    return level_qg(schedule, channels, quantization, gate, chroma_loss)


def tile_stream_bytes(t, s: Settings, channels: int) -> int:
    """Bytes of one tile's uncompressed stream: the Kagari block's
    capacity and the raw block's size."""
    if s.wavelet == Wavelet.NONE:
        return t.w * t.h * channels * 2
    return geometry.tile_data_size(t.w, t.h) * channels


def encode_tiles_device(
    image: np.ndarray,
    s: Settings,
    device: torch.device,
    events: Optional[EventsCallback] = None,
    events_user=None,
) -> list:
    """Run the device stage for every tile; returns a list of int16
    numpy coefficient streams in tile (row-major) order."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)

    out: list = [None] * total
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        t0 = tiles[0].index
        fire(events, t0, total, Event.FORMAT_START, events_user)
        batch = np.stack([image[t.y : t.y + th, t.x : t.x + tw, :] for t in tiles], axis=0)
        tiles_dev = torch.from_numpy(batch).to(device)
        fire(events, t0, total, Event.FORMAT_END, events_user)
        fire(events, t0, total, Event.WAVELET_START, events_user)
        planes = to_planar_yuv(tiles_dev, s.color, bool(s.discard_non_visible)).contiguous()
        if s.wavelet == Wavelet.NONE:
            streams = planes.reshape(len(tiles), -1)
        else:
            schedule = geometry.lift_schedule(tw, th)
            qg = tile_qg(tw, th, channels, s.quantization, s.gate, s.chroma_loss)
            streams = forward_tile(planes, schedule, s.wavelet, s.wrap, qg)
        coeffs = streams.cpu().numpy()
        fire(events, t0, total, Event.WAVELET_END, events_user)
        for i, t in enumerate(tiles):
            out[t.index] = coeffs[i]
    return out


def encode(
    image: np.ndarray,
    settings: Optional[Settings] = None,
    events: Optional[EventsCallback] = None,
    events_user=None,
    device=None,
) -> bytes:
    """Encode an interleaved uint8 image of shape (h, w, channels) or
    (h, w). Returns the .ako blob; raises AkoError on failure.

    `device`: where the colour transform and the lift run; None means
    the CUDA card (raises when there is none), "cpu" the plain torch
    path. `events` is the per-stage tracing hook (core.events)."""
    if image is None:
        raise AkoError(Status.INVALID_INPUT)
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.dtype != np.uint8:
        raise AkoError(Status.INVALID_INPUT, "expected uint8 (h, w, ch)")
    dev = resolve_device(device)

    s = checked_settings(settings)
    image_h, image_w, channels = image.shape
    head = container.head_write(channels, image_w, image_h, s)

    streams = encode_tiles_device(image, s, dev, events, events_user)

    blocks = [head]
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    for t, values in zip(grid, streams):
        fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        if effective_method(s.compression) == Compression.KAGARI:
            block = compress_block(values, tile_stream_bytes(t, s, channels))
            if block is None:
                raise AkoError(Status.ERROR, "incompressible tile")
            blocks.append(block)
        else:
            blocks.append(values.tobytes())
        fire(events, t.index, total, Event.COMPRESSION_END, events_user)

    return b"".join(blocks)

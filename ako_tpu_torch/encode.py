"""Encode orchestrator: image -> .ako blob.

Two paths, as in ako_tpu's encode (ako_tpu/encode.py:962-1003):

- device entropy (the default on the card; ako_tpu/encode.py:378-568):
  per tile-shape group, the tiles go to the device once as (T, h, w, C)
  u8 (a constant last channel stays on the host and is broadcast on the
  device), and the colour transform, the lift with quantization and
  gate, and the Kagari tokenize + pack (ops/kagari_device.py) run
  there. Only the (T,) compressed sizes and the compressed rows come
  back; tiles near the capacity take the host coder on the stream that
  is already on the device.
- host entropy (device_entropy=False; ako_tpu/encode.py:333-375 then
  :983-1003): the (T, coeff_count) int16 streams come back once and the
  host coder (akort.c) compresses each tile: Kagari, or rANS for
  MANBAVARAN under AKO_TPU_MANBAVARAN=1 (runtime/kagari.py).

The host assembles the container. Blob bytes are identical to
ako_tpu's and the reference encoder's for every settings combination.
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
from ako_tpu_torch.ops.kagari_device import kagari_encode_device
from ako_tpu_torch.ops.lifting import forward_tiles
from ako_tpu_torch.ops.quantization import level_qg
from ako_tpu_torch.runtime.kagari import BLOCK_HEAD, compress_block, effective_method
from ako_tpu_torch.utils import metrics

#: device-entropy fallback margin: within this many bytes of capacity,
#: the host coder decides, so the reference's exact bounds checks
#: (kagari.c:66-78,95-110) keep their failure semantics
_CAPACITY_MARGIN = 16


def pack_budget(capacity: int, quantization: int) -> int:
    """Device Kagari packer byte budget, as ako_tpu's (so the same tiles
    take the host coder): capacity/2 lossy, 7/8 lossless, at least
    4096."""
    budget = capacity // 2 if quantization > 0 else capacity * 7 // 8
    return max(budget, 4096)


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


def image_fill_val(image: np.ndarray) -> Optional[int]:
    """The value of a constant trailing channel (the alpha=255 norm) of
    a 2- or 4-channel image, else None: the device-entropy encoder then
    uploads one channel fewer and broadcasts it on the device."""
    channels = image.shape[-1]
    if channels in (2, 4) and image.size:
        # torch's compare of the strided plane runs on several threads
        a = torch.from_numpy(image)[..., -1]
        first = int(image.flat[channels - 1])
        if bool(a.eq(first).all()):
            return first
    return None


def stage_tiles(src, tiles, tw: int, th: int):
    """The shape group's tiles of src (h, w, c) as one (T, th, tw, c)
    tensor. A group of geometry.tile_grid is a row-major rectangle of
    tiles spaced by their own size, so this is one strided copy; cutting
    the tiles out one by one costs several times more."""
    y0, x0 = tiles[0].y, tiles[0].x
    ny = len({t.y for t in tiles})
    nx = len(tiles) // ny
    if [(t.y, t.x) for t in tiles] != [
        (y0 + i * th, x0 + j * tw) for i in range(ny) for j in range(nx)
    ]:
        raise ValueError("stage_tiles: the tiles are not a row-major rectangle")
    sh, sw, sc = src.stride()
    view = src.as_strided(
        (ny, nx, th, tw, src.shape[2]),
        (th * sh, tw * sw, sh, sw, sc),
        src.storage_offset() + y0 * sh + x0 * sw,
    )
    return view.reshape(len(tiles), th, tw, src.shape[2])


def forward_streams(tiles_dev, tw: int, th: int, channels: int, s: Settings):
    """(T, th, tw, channels) u8 tiles on the device -> (T, coeff_count)
    int16 serialized streams: colour transform, lift, quantize/gate (in
    the fused wiring one lift_pyramid launch, ops/lifting.py
    forward_tiles)."""
    discard = bool(s.discard_non_visible)
    if s.wavelet == Wavelet.NONE:
        planes = to_planar_yuv(tiles_dev, s.color, discard).contiguous()
        return planes.reshape(planes.shape[0], -1)
    schedule = geometry.lift_schedule(tw, th)
    qg = tile_qg(tw, th, channels, s.quantization, s.gate, s.chroma_loss)
    return forward_tiles(tiles_dev, schedule, s.wavelet, s.wrap, qg, s.color, discard)


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
        coeffs = forward_streams(tiles_dev, tw, th, channels, s).cpu().numpy()
        fire(events, t0, total, Event.WAVELET_END, events_user)
        for i, t in enumerate(tiles):
            out[t.index] = coeffs[i]
    return out


def dispatch_tiles_fused(
    image: np.ndarray,
    s: Settings,
    device: torch.device,
    events: Optional[EventsCallback] = None,
    events_user=None,
) -> tuple:
    """Device-entropy encode, phase 1: per shape group one u8 upload,
    then colour + lift + quantize/gate + tokenize/pack on the device,
    enqueued without waiting. Returns (grid, per-group records).

    Events fire per shape group (tile_no = the group's first tile), as
    in ako_tpu's fused path: FORMAT covers host staging + upload."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    image = np.ascontiguousarray(image)  # torch takes no negative strides
    fill_val = image_fill_val(image)
    src = torch.from_numpy(image)
    if fill_val is not None:
        src = src[..., :-1]

    dispatched = []
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        capacity = tile_stream_bytes(tiles[0], s, channels) - BLOCK_HEAD.size
        budget = pack_budget(capacity, s.quantization)
        t0 = tiles[0].index
        fire(events, t0, total, Event.FORMAT_START, events_user)
        tiles_dev = stage_tiles(src, tiles, tw, th).to(device)
        fire(events, t0, total, Event.FORMAT_END, events_user)
        if fill_val is not None:
            last = tiles_dev.new_full(tiles_dev.shape[:-1] + (1,), fill_val)
            tiles_dev = torch.cat([tiles_dev, last], dim=-1)
        # the stream stays on the device for the near-capacity fallback,
        # so no tile is lifted twice
        stream = forward_streams(tiles_dev, tw, th, channels, s)
        comp, totals = kagari_encode_device(stream, capacity, budget)
        dispatched.append((tiles, stream, comp, totals, capacity, budget))
    return grid, dispatched


def collect_tiles_blocks(grid, dispatched, events=None, events_user=None) -> list:
    """Device-entropy encode, phase 2: per shape group one download of
    the (T,) totals and one of the compressed rows, cut at the group's
    largest total; frame the blocks. Tiles over the budget or within
    _CAPACITY_MARGIN of the capacity take the host coder on their
    stream, and both kinds are counted (utils/metrics.py).

    WAVELET covers the wait for the group's device work, COMPRESSION
    the byte download and framing."""
    total = len(grid)
    out: list = [None] * total
    for tiles, stream, comp, totals_dev, capacity, budget in dispatched:
        t0 = tiles[0].index
        fire(events, t0, total, Event.WAVELET_START, events_user)
        totals = totals_dev.cpu().numpy()
        fire(events, t0, total, Event.WAVELET_END, events_user)
        fire(events, t0, total, Event.COMPRESSION_START, events_user)
        host = (totals > budget) | (totals >= capacity - _CAPACITY_MARGIN)
        ok = np.flatnonzero(~host)
        fallback = np.flatnonzero(host)
        metrics.bump(metrics.ENC_DEVICE, len(ok))
        metrics.bump(metrics.ENC_HOST_FALLBACK, len(fallback))
        if len(ok):
            rows = comp[:, : int(totals[ok].max())].cpu().numpy()
            for i in ok:
                n = int(totals[i])
                out[tiles[i].index] = BLOCK_HEAD.pack(n) + rows[i, :n].tobytes()
        if len(fallback):
            streams = stream[torch.from_numpy(fallback).to(stream.device)].cpu().numpy()
            for values, i in zip(streams, fallback):
                block = compress_block(values, capacity + BLOCK_HEAD.size)
                if block is None:
                    raise AkoError(Status.ERROR, "incompressible tile")
                out[tiles[i].index] = block
        fire(events, t0, total, Event.COMPRESSION_END, events_user)
    return out


def encode(
    image: np.ndarray,
    settings: Optional[Settings] = None,
    events: Optional[EventsCallback] = None,
    events_user=None,
    device=None,
    device_entropy: Optional[bool] = None,
) -> bytes:
    """Encode an interleaved uint8 image of shape (h, w, channels) or
    (h, w). Returns the .ako blob; raises AkoError on failure.

    `device`: where the colour transform and the lift run; None means
    the CUDA card (raises when there is none), "cpu" the plain torch
    path. `device_entropy`: Kagari coding on the device too; None means
    yes on a CUDA device and no on the CPU, as ako_tpu's rule for its
    backend. `events` is the per-stage tracing hook (core.events)."""
    if image is None:
        raise AkoError(Status.INVALID_INPUT)
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.dtype != np.uint8:
        raise AkoError(Status.INVALID_INPUT, "expected uint8 (h, w, ch)")
    dev = resolve_device(device)
    if device_entropy is None:
        device_entropy = dev.type == "cuda"

    s = checked_settings(settings)
    image_h, image_w, channels = image.shape
    head = container.head_write(channels, image_w, image_h, s)
    method = effective_method(s.compression)

    if device_entropy and method == Compression.MANBAVARAN:
        # ako_tpu codes these tiles with its device rANS encoder, which
        # the port does not have yet; no host coder stands in for it
        raise NotImplementedError(
            "device-entropy MANBAVARAN (AKO_TPU_MANBAVARAN=1) needs the device rANS coder K6, "
            "ROADMAP item 5; pass device_entropy=False")
    if device_entropy and method == Compression.KAGARI:
        # KAGARI and the reserved MANBAVARAN flag (Kagari bytes)
        grid, dispatched = dispatch_tiles_fused(image, s, dev, events, events_user)
        return head + b"".join(collect_tiles_blocks(grid, dispatched, events, events_user))

    streams = encode_tiles_device(image, s, dev, events, events_user)

    blocks = [head]
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    for t, values in zip(grid, streams):
        fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        if s.compression != Compression.NONE:
            block = compress_block(values, tile_stream_bytes(t, s, channels), s.compression)
            if block is None:
                raise AkoError(Status.ERROR, "incompressible tile")
            blocks.append(block)
        else:
            blocks.append(values.tobytes())
        fire(events, t.index, total, Event.COMPRESSION_END, events_user)

    return b"".join(blocks)

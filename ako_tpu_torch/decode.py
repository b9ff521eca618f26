"""Decode orchestrator: .ako blob -> image.

Two paths, as in ako_tpu's decode (ako_tpu/decode.py:974-1043):

- device entropy (the default on the card; ako_tpu/decode.py:732-929):
  the host walks the tile blocks and scans each Kagari payload for
  per-block sync records (akort_kagari_sync); per tile-shape group one
  upload carries the payloads as a dense word pool plus the records,
  and the block-parallel Kagari decode (ops/kagari_device.py, kernel
  K4), the dequantize, the unlift and the inverse colour transform run
  on the device; one pixel download per group, then placement. Quirk
  streams (gamma codes over 31 bits) are decoded on the host and
  counted (utils/metrics.py).
- host entropy (device_entropy=False, and MANBAVARAN-flagged blobs):
  the host entropy-decodes every tile block into its int16 stream
  (akort.c); per group the streams go to the device once and the
  (T, h, w, C) u8 tiles come back once.

Pixels are bit-identical to ako_tpu's and the reference decoder's.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch

from ako_tpu_torch.core import container, geometry
from ako_tpu_torch.core.events import Event, EventsCallback, fire
from ako_tpu_torch.core.settings import AkoError, Compression, Settings, Status, Wavelet
from ako_tpu_torch.encode import resolve_device, tile_stream_bytes
from ako_tpu_torch.ops.colorspace import to_interleaved_u8
from ako_tpu_torch.ops.kagari_device import (
    DECODE_BLOCK,
    DECODE_SLACK_WORDS,
    decode_span_words,
    kagari_decode_device,
)
from ako_tpu_torch.ops.lifting import inverse_tiles
from ako_tpu_torch.runtime.kagari import BLOCK_HEAD, decompress_block, kagari_decode, kagari_sync
from ako_tpu_torch.utils import metrics

#: Upper bound on decoded image bytes (w*h*channels). The reference
#: relies on malloc failing for absurd headers (status
#: NO_ENOUGH_MEMORY, encode.c:94-98); reject them before allocating.
MAX_IMAGE_BYTES = 1 << 31


_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None


def scan_pool() -> ThreadPoolExecutor:
    """Worker threads for the tiles' host sync scans: the native scanner
    runs without the GIL (a ctypes call), so the scans of one image run
    on all cores, as in ako_tpu/decode.py:779."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(os.cpu_count() or 1, thread_name_prefix="ako-sync")
        return _pool


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


def stream_pixels(coeffs, tw: int, th: int, channels: int, s: Settings):
    """(T, coeff_count) int16 streams on the device -> (T, th, tw,
    channels) u8 tiles on the device: dequantize, unlift, inverse
    colour, interleaved there (placing channel-strided tiles on the
    host costs more than the transpose); in the fused wiring one
    unlift_pyramid launch (ops/lifting.py inverse_tiles)."""
    if s.wavelet == Wavelet.NONE:
        planes = coeffs.reshape(coeffs.shape[:-1] + (channels, th, tw))
        return to_interleaved_u8(planes, s.color, channels).contiguous()
    schedule = geometry.lift_schedule(tw, th)
    return inverse_tiles(coeffs, schedule, s.wavelet, s.wrap, channels, s.color)


def decode_tiles_device(streams, tw: int, th: int, channels: int, s: Settings,
                        device: torch.device) -> np.ndarray:
    """(T, coeff_count) int16 streams -> (T, th, tw, channels) u8 tiles:
    one upload, the unlift and inverse colour on `device`, one download."""
    coeffs = torch.from_numpy(streams).to(device)
    return stream_pixels(coeffs, tw, th, channels, s).cpu().numpy()


def pack_entropy_upload(items) -> tuple:
    """One shape group's device-decode input as one int32 buffer:
    [base (T) | bit_off (T*B) | prev (T*B) | consec (T*B) | run (T*B) |
    word pool]. The pool holds the payloads word-aligned, tile i from
    word base[i], as big-endian 32-bit words (bit patterns), then
    DECODE_SLACK_WORDS zero words. items: (tile, payload, sync record)
    triples. Returns (buf, T, B)."""
    bases, w = [], 0
    for _, p, _ in items:
        bases.append(w)
        w += (len(p) + 3) // 4
    pool8 = np.zeros((w + DECODE_SLACK_WORDS) * 4, np.uint8)
    for (_, p, _), b in zip(items, bases):
        pool8[b * 4 : b * 4 + len(p)] = np.frombuffer(p, np.uint8)
    T, B = len(items), len(items[0][2][0])
    sync = [np.stack([sy[k] for _, _, sy in items]).astype(np.int64) for k in range(4)]
    head = np.concatenate([np.asarray(bases, np.int64)] + [a.ravel() for a in sync])
    pool = pool8.view(">u4").astype(np.uint32).view(np.int32)
    return np.concatenate([head.astype(np.uint32).view(np.int32), pool]), T, B


def split_entropy_upload(buf, T: int, B: int):
    """Views (pool, base, bit_off, prev, consec, run) of a
    pack_entropy_upload buffer, in kagari_decode_device's order."""
    base = buf[:T]
    bit_off, prev, consec, run = (buf[T + k * T * B : T + (k + 1) * T * B].view(T, B)
                                  for k in range(4))
    return buf[T + 4 * T * B :], base, bit_off, prev, consec, run


def dispatch_tiles_device_entropy(view, cursor: int, grid, s: Settings, channels: int,
                                  device: torch.device, events=None, events_user=None) -> list:
    """Device-entropy decode, phase 1: walk the blocks and scan them for
    sync records on the host, then per shape group upload, decode, unlift
    and format on the device, enqueued without waiting. Returns
    (tiles, th, tw, pixels on the device) per group.

    Events as in ako_tpu's fused path: one COMPRESSION pair (tile 0)
    around the walk and the scans, then one per group around its upload
    and dispatch."""
    total = len(grid)
    fire(events, 0, total, Event.COMPRESSION_START, events_user)
    # the block sizes live in the block heads: a sequential walk ...
    blocks = []
    for t in grid:
        if cursor + BLOCK_HEAD.size > len(view):
            raise AkoError(Status.BROKEN_INPUT)
        (bs,) = BLOCK_HEAD.unpack_from(view, cursor)
        payload = view[cursor + BLOCK_HEAD.size : cursor + BLOCK_HEAD.size + bs]
        if len(payload) < bs:
            raise AkoError(Status.BROKEN_INPUT)
        cursor += BLOCK_HEAD.size + bs
        blocks.append((t, payload))

    # ... then independent scans on the worker threads
    def scan(block):
        t, payload = block
        tds, spacing = tile_block_sizes(t, s, channels)
        return kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK)

    syncs = list(scan_pool().map(scan, blocks))
    fire(events, 0, total, Event.COMPRESSION_END, events_user)

    per_shape: dict = {}
    host_tiles: dict = {}
    for (t, payload), sync in zip(blocks, syncs):
        if sync is None or sync[4] != len(payload):
            raise AkoError(Status.BROKEN_INPUT)
        # quirk streams (zigzag(-32768) codes over 31 bits) stay on the host
        group = host_tiles if sync[5] > 31 else per_shape
        group.setdefault((t.w, t.h), []).append((t, payload, sync))
    metrics.bump(metrics.DEC_DEVICE, sum(map(len, per_shape.values())))
    metrics.bump(metrics.DEC_HOST_FALLBACK, sum(map(len, host_tiles.values())))

    dispatched = []
    for (tw, th), items in per_shape.items():
        t0 = items[0][0].index
        fire(events, t0, total, Event.COMPRESSION_START, events_user)
        count = tile_block_sizes(items[0][0], s, channels)[0] // 2
        span = None  # K4 reads the pool; only the plain decoder needs a window
        if device.type == "cpu":
            span = max(decode_span_words(sy[0], len(p) * 8) for _, p, sy in items)
        buf, T, B = pack_entropy_upload(items)
        parts = split_entropy_upload(torch.from_numpy(buf).to(device), T, B)
        coeffs = kagari_decode_device(*parts, count, DECODE_BLOCK, span)
        pixels = stream_pixels(coeffs, tw, th, channels, s)
        fire(events, t0, total, Event.COMPRESSION_END, events_user)
        dispatched.append(([t for t, _, _ in items], th, tw, pixels))

    for (tw, th), items in host_tiles.items():
        t0 = items[0][0].index
        fire(events, t0, total, Event.COMPRESSION_START, events_user)
        streams = []
        for t, payload, _ in items:
            tds, spacing = tile_block_sizes(t, s, channels)
            res = kagari_decode(tds // 2, payload, tds + spacing)
            if res is None:
                raise AkoError(Status.BROKEN_INPUT)
            streams.append(res[0])
        coeffs = torch.from_numpy(np.stack(streams)).to(device)
        pixels = stream_pixels(coeffs, tw, th, channels, s)
        fire(events, t0, total, Event.COMPRESSION_END, events_user)
        dispatched.append(([t for t, _, _ in items], th, tw, pixels))
    return dispatched


def decode(
    blob: bytes,
    events: Optional[EventsCallback] = None,
    events_user=None,
    device=None,
    device_entropy: Optional[bool] = None,
) -> Tuple[np.ndarray, Settings, int]:
    """Decode an .ako blob. Returns (image uint8 (h, w, channels),
    settings-from-header, channels); raises AkoError on failure.
    `device` and `device_entropy` as for encode: None means the CUDA
    card with Kagari decoded there, "cpu" the plain torch path with the
    host entropy decoder."""
    if blob is None:
        raise AkoError(Status.INVALID_INPUT)
    dev = resolve_device(device)
    if device_entropy is None:
        device_entropy = dev.type == "cuda"
    view = memoryview(blob)
    channels, image_w, image_h, s = container.head_read(view)
    _check_decode_budget(image_w, image_h, channels)
    cursor = container.HEAD_SIZE

    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    image = np.empty((image_h, image_w, channels), dtype=np.uint8)

    if device_entropy and s.compression == Compression.KAGARI:
        dispatched = dispatch_tiles_device_entropy(
            view, cursor, grid, s, channels, dev, events, events_user
        )
        # WAVELET covers the wait for each group's device work, FORMAT
        # the pixel download and placement
        for tiles, _th, _tw, pixels in dispatched:
            fire(events, tiles[0].index, total, Event.WAVELET_START, events_user)
            if pixels.is_cuda:
                torch.cuda.current_stream(pixels.device).synchronize()
            fire(events, tiles[0].index, total, Event.WAVELET_END, events_user)
        for tiles, th, tw, pixels in dispatched:
            fire(events, tiles[0].index, total, Event.FORMAT_START, events_user)
            pix = pixels.cpu().numpy()
            for i, t in enumerate(tiles):
                image[t.y : t.y + th, t.x : t.x + tw, :] = pix[i]
            fire(events, tiles[0].index, total, Event.FORMAT_END, events_user)
        return image, s, channels

    # Host: entropy-decode every tile block into its coefficient stream
    streams: list = []
    for t in grid:
        fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        values, cursor = read_tile_stream(view, cursor, t, s, channels)
        fire(events, t.index, total, Event.COMPRESSION_END, events_user)
        streams.append(values)

    # Device: batched unlift + format per tile shape
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

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
  A MANBAVARAN-flagged block is first scanned as a rANS payload
  (akort_manba_sync); its group decodes on the device through the
  block-parallel rANS decoder (ops/manba_device.py, kernel K6d). A
  reserved-flag block that holds Kagari bytes fails that scan and takes
  the Kagari route.
- host entropy (device_entropy=False): the host entropy-decodes every
  tile block into its int16 stream (akort.c); per group the streams go
  to the device once and the (T, h, w, C) u8 tiles come back once.

Two modes of ako_tpu are kept: AKO_TPU_DECODE=host decodes every tile
with the native runtime alone (runtime/hostcodec.py), and
AKO_TPU_EVENTS=tile with an events callback runs the device-entropy
Kagari path one tile at a time with the reference's per-tile event
pairs. decode_tiles_iter is the streaming decode: tiles come out as
their blocks are read.

Pixels are bit-identical to ako_tpu's and the reference decoder's.
"""

from __future__ import annotations

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ako_tpu_torch.core import container, geometry
from ako_tpu_torch.core.events import Event, EventsCallback, fire
from ako_tpu_torch.core.settings import AkoError, Compression, Settings, Status, Wavelet
from ako_tpu_torch.encode import (
    resolve_device,
    tile_events_mode,
    tile_stream_bytes,
    to_device,
    wait_device,
)
from ako_tpu_torch.ops.colorspace import to_interleaved_u8
from ako_tpu_torch.ops.kagari_device import (
    DECODE_BLOCK,
    DECODE_SLACK_WORDS,
    decode_span_words,
    kagari_decode_device,
)
from ako_tpu_torch.ops.lifting import inverse_tiles
from ako_tpu_torch.ops.manba_device import SYMS, manba_decode_device, span_words
from ako_tpu_torch.runtime import hostcodec
from ako_tpu_torch.runtime.kagari import (
    BLOCK_HEAD,
    decompress_block,
    kagari_decode,
    kagari_sync,
    manba_sync,
)
from ako_tpu_torch.utils import metrics
from ako_tpu_torch.utils.debug import dev_printf
from ako_tpu_torch.utils.tracing import traced

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


class HostDecodeSpanPlan(NamedTuple):
    """Per-(geometry, wavelet) arrays of the batched native span decoder
    (hostcodec.tile_decode_spans; ako_tpu/decode.py:291), the decode twin
    of encode.host_span_plan. In tile order, read-only."""

    rects: np.ndarray  # (n, 4) int32: x, y, w, h
    counts: np.ndarray  # (n,) int64 coefficients a tile
    caps: np.ndarray  # (n,) int64 output capacity bytes (tds + spacing)


@functools.lru_cache(maxsize=64)
def host_decode_plan(image_w: int, image_h: int, channels: int, tiles_dimension: int,
                     wavelet: Wavelet) -> HostDecodeSpanPlan:
    """The span decode plan of an image geometry (ako_tpu/decode.py:301
    _host_decode_plan)."""
    grid = geometry.tile_grid(image_w, image_h, tiles_dimension)
    n = len(grid)
    rects = np.empty((n, 4), np.int32)
    counts = np.empty(n, np.int64)
    caps = np.empty(n, np.int64)
    for i, t in enumerate(grid):
        rects[i] = (t.x, t.y, t.w, t.h)
        if wavelet != Wavelet.NONE:
            tds = geometry.tile_data_size(t.w, t.h) * channels
            spacing = geometry.planes_spacing(t.w, t.h)
        else:
            tds, spacing = t.w * t.h * channels * 2, 0
        counts[i] = tds // 2
        caps[i] = tds + spacing
    for a in (rects, counts, caps):
        a.setflags(write=False)
    return HostDecodeSpanPlan(rects, counts, caps)


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


def host_decode_mode() -> bool:
    """AKO_TPU_DECODE=host: every tile's entropy decode, unlift and
    inverse colour transform run in the native runtime
    (runtime/hostcodec.py), one tile at a time with the reference's
    per-tile events, and the device is not used (ako_tpu/decode.py:360)."""
    return os.environ.get("AKO_TPU_DECODE") == "host"


def read_tile_block(view, cursor: int, t, s: Settings, channels: int):
    """Slice one tile's block payload (or raw block) out of the container
    without decoding it; returns (payload view, new_cursor). Raises
    AkoError(BROKEN_INPUT) on truncation."""
    tds, _ = tile_block_sizes(t, s, channels)
    if s.compression != Compression.NONE:
        if cursor + BLOCK_HEAD.size > len(view):
            raise AkoError(Status.BROKEN_INPUT)
        (bs,) = BLOCK_HEAD.unpack_from(view, cursor)
        payload = view[cursor + BLOCK_HEAD.size : cursor + BLOCK_HEAD.size + bs]
        if len(payload) < bs:
            raise AkoError(Status.BROKEN_INPUT)
        return payload, cursor + BLOCK_HEAD.size + bs
    if cursor + tds > len(view):
        raise AkoError(Status.BROKEN_INPUT)
    return view[cursor : cursor + tds], cursor + tds


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


def pack_manba_upload(items) -> tuple:
    """One shape group's Manbavaran decode input as one int32 buffer
    (ako_tpu/decode.py:502-563): [base (T) | rans_end (T) | extras_off
    (T) | x (T*B) | rbyte (T*B) | ebit (T*B) | freq (T*17) | word pool],
    the pool as pack_entropy_upload's. items: (tile, payload, manba_sync
    record) triples. Returns (buf, T, B)."""
    bases, w = [], 0
    for _, p, _ in items:
        bases.append(w)
        w += (len(p) + 3) // 4
    pool8 = np.zeros((w + DECODE_SLACK_WORDS) * 4, np.uint8)
    for (_, p, _), b in zip(items, bases):
        pool8[b * 4 : b * 4 + len(p)] = np.frombuffer(p, np.uint8)
    syncs = [sy for _, _, sy in items]
    T, B = len(items), len(syncs[0][0])
    head = [np.asarray(bases, np.int64), [sy[5] for sy in syncs], [sy[6] for sy in syncs]]
    head += [np.stack([sy[k] for sy in syncs]).ravel() for k in range(4)]
    head = np.concatenate([np.asarray(a, np.int64) for a in head])
    pool = pool8.view(">u4").astype(np.uint32).view(np.int32)
    return np.concatenate([head.astype(np.uint32).view(np.int32), pool]), T, B


def split_manba_upload(buf, T: int, B: int):
    """Views (pool, base, rans_end, extras_off, x, rbyte, ebit, freq) of
    a pack_manba_upload buffer, in manba_decode_device's order."""
    base, rans_end, extras_off = (buf[k * T : (k + 1) * T] for k in range(3))
    x, rbyte, ebit = (buf[3 * T + k * T * B : 3 * T + (k + 1) * T * B].view(T, B)
                      for k in range(3))
    at = 3 * T + 3 * T * B
    freq = buf[at : at + T * SYMS].view(T, SYMS)
    return buf[at + T * SYMS :], base, rans_end, extras_off, x, rbyte, ebit, freq


def manba_spans(items) -> tuple:
    """(rspan, espan): the plain decoder's window widths for a group
    (span_words over every tile's rANS and extras records)."""
    rspan = max(span_words(sy[1], sy[5], bits=False) for _, _, sy in items)
    espan = max(span_words(sy[2].astype(np.int64) + sy[6] * 8, len(p) * 8, bits=True)
                for _, p, sy in items)
    return rspan, espan


def dispatch_tiles_device_entropy(view, cursor: int, grid, s: Settings, channels: int,
                                  device: torch.device, events=None, events_user=None,
                                  pool: Optional[ThreadPoolExecutor] = None, host=None) -> list:
    """Device-entropy decode, phase 1: walk the blocks and scan them for
    sync records on the host, then per shape group upload, decode, unlift
    and format on the device, enqueued without waiting. Returns
    (tiles, th, tw, pixels on the device) per group: the Kagari groups,
    then the Manbavaran ones, then the quirk tiles'. The scans run on
    `pool` (scan_pool() when None); given an executor slot `host`
    (runtime/executor.py Slot), the uploads go through its pinned buffers
    on its stream.

    Events as in ako_tpu's fused path: one COMPRESSION pair (tile 0)
    around the walk and the scans, then one per group around its upload
    and dispatch."""
    total = len(grid)
    fire(events, 0, total, Event.COMPRESSION_START, events_user)
    # the block sizes live in the block heads: a sequential walk ...
    blocks = []
    for t in grid:
        payload, cursor = read_tile_block(view, cursor, t, s, channels)
        blocks.append((t, payload))

    # ... then independent scans on the worker threads; a MANBAVARAN
    # flagged block is tried as rANS first (reserved-flag blocks holding
    # Kagari bytes fail its magic check and scan as Kagari)
    def scan(block):
        t, payload = block
        tds, spacing = tile_block_sizes(t, s, channels)
        if s.compression == Compression.MANBAVARAN:
            ms = manba_sync(tds // 2, payload, DECODE_BLOCK)
            if ms is not None:
                return "manba", ms
        return "kagari", kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK)

    syncs = list((scan_pool() if pool is None else pool).map(scan, blocks))
    fire(events, 0, total, Event.COMPRESSION_END, events_user)

    per_shape: dict = {}
    per_shape_manba: dict = {}
    host_tiles: dict = {}
    for (t, payload), (kind, sync) in zip(blocks, syncs):
        # the consumed byte count must be the block's size
        if sync is None or sync[7 if kind == "manba" else 4] != len(payload):
            raise AkoError(Status.BROKEN_INPUT)
        if kind == "manba":
            group = per_shape_manba
        else:
            # quirk streams (zigzag(-32768) codes over 31 bits) stay on the host
            group = host_tiles if sync[5] > 31 else per_shape
        group.setdefault((t.w, t.h), []).append((t, payload, sync))
    metrics.bump(metrics.DEC_DEVICE, sum(map(len, per_shape.values()))
                 + sum(map(len, per_shape_manba.values())))
    quirks = sum(map(len, host_tiles.values()))
    metrics.bump(metrics.DEC_HOST_FALLBACK, quirks)
    if quirks:
        dev_printf("dec: %d/%d quirk streams (gamma codes > 31 bits) decoded on host",
                   quirks, total)

    dispatched = []
    for (tw, th), items in per_shape.items():
        t0 = items[0][0].index
        fire(events, t0, total, Event.COMPRESSION_START, events_user)
        count = tile_block_sizes(items[0][0], s, channels)[0] // 2
        span = None  # K4 reads the pool; only the plain decoder needs a window
        if device.type == "cpu":
            span = max(decode_span_words(sy[0], len(p) * 8) for _, p, sy in items)
        buf, T, B = pack_entropy_upload(items)
        parts = split_entropy_upload(
            to_device(torch.from_numpy(buf), device, host, ("kagari", tw, th)), T, B)
        coeffs = kagari_decode_device(*parts, count, DECODE_BLOCK, span)
        pixels = stream_pixels(coeffs, tw, th, channels, s)
        fire(events, t0, total, Event.COMPRESSION_END, events_user)
        dispatched.append(([t for t, _, _ in items], th, tw, pixels))

    for (tw, th), items in per_shape_manba.items():
        t0 = items[0][0].index
        fire(events, t0, total, Event.COMPRESSION_START, events_user)
        count = tile_block_sizes(items[0][0], s, channels)[0] // 2
        # K6d reads the pool; only the plain decoder needs windows
        spans = manba_spans(items) if device.type == "cpu" else (None, None)
        buf, T, B = pack_manba_upload(items)
        parts = split_manba_upload(
            to_device(torch.from_numpy(buf), device, host, ("manba", tw, th)), T, B)
        coeffs = manba_decode_device(*parts, count, DECODE_BLOCK, *spans)
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
        coeffs = to_device(torch.from_numpy(np.stack(streams)), device, host, ("quirk", tw, th))
        pixels = stream_pixels(coeffs, tw, th, channels, s)
        fire(events, t0, total, Event.COMPRESSION_END, events_user)
        dispatched.append(([t for t, _, _ in items], th, tw, pixels))
    return dispatched


def decode_tiles_host(view, cursor: int, grid, s: Settings, channels: int, image,
                      events=None, events_user=None) -> None:
    """AKO_TPU_DECODE=host: every tile through the native runtime into
    `image`, with the reference's per-tile events (ako_tpu/decode.py:
    948-972): COMPRESSION around the entropy decode, WAVELET around the
    unlift, FORMAT around the inverse colour transform and placement."""
    total = len(grid)
    for t in grid:
        fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        values, cursor = read_tile_stream(view, cursor, t, s, channels)
        fire(events, t.index, total, Event.COMPRESSION_END, events_user)
        fire(events, t.index, total, Event.WAVELET_START, events_user)
        planes = hostcodec.tile_unlift(values, t.w, t.h, channels, s.wavelet, s.wrap)
        fire(events, t.index, total, Event.WAVELET_END, events_user)
        fire(events, t.index, total, Event.FORMAT_START, events_user)
        image[t.y : t.y + t.h, t.x : t.x + t.w] = hostcodec.planes_to_u8(planes, s.color)
        fire(events, t.index, total, Event.FORMAT_END, events_user)


def decode_tile_events(view, cursor: int, grid, s: Settings, channels: int, image,
                       device: torch.device, events, events_user) -> None:
    """The device-entropy Kagari decode one tile at a time into `image`,
    with the reference's per-tile event pairs (ako.h:75-84;
    ako_tpu/decode.py:1046-1098): COMPRESSION around the sync scan, the
    upload and the block decode (a quirk stream decodes on the host, as
    in the batched path), WAVELET around the unlift and inverse colour,
    FORMAT around the pixel download and placement; each stage boundary
    waits for the device. A tracing mode: the same pixels as the batched
    path, at the cost of one dispatch a tile."""
    total = len(grid)
    for t in grid:
        payload, cursor = read_tile_block(view, cursor, t, s, channels)
        tds, spacing = tile_block_sizes(t, s, channels)
        fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        sync = kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK)
        if sync is None or sync[4] != len(payload):
            raise AkoError(Status.BROKEN_INPUT)
        if sync[5] > 31:
            metrics.bump(metrics.DEC_HOST_FALLBACK)
            values = kagari_decode(tds // 2, payload, tds + spacing)[0]
            coeffs = torch.from_numpy(values[None]).to(device)
        else:
            metrics.bump(metrics.DEC_DEVICE)
            span = decode_span_words(sync[0], len(payload) * 8) if device.type == "cpu" else None
            buf, T, B = pack_entropy_upload([(t, payload, sync)])
            parts = split_entropy_upload(torch.from_numpy(buf).to(device), T, B)
            coeffs = kagari_decode_device(*parts, tds // 2, DECODE_BLOCK, span)
        wait_device(coeffs)
        fire(events, t.index, total, Event.COMPRESSION_END, events_user)
        fire(events, t.index, total, Event.WAVELET_START, events_user)
        pixels = stream_pixels(coeffs, t.w, t.h, channels, s)
        wait_device(pixels)
        fire(events, t.index, total, Event.WAVELET_END, events_user)
        fire(events, t.index, total, Event.FORMAT_START, events_user)
        image[t.y : t.y + t.h, t.x : t.x + t.w, :] = pixels.cpu().numpy()[0]
        fire(events, t.index, total, Event.FORMAT_END, events_user)


@traced
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
    card with Kagari and Manbavaran decoded there, "cpu" the plain torch
    path with the host entropy decoder. AKO_TPU_EVENTS=tile makes the
    device-entropy Kagari path fire `events` per tile; AKO_TPU_DECODE=host
    decodes every tile in the native runtime."""
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

    if host_decode_mode():
        decode_tiles_host(view, cursor, grid, s, channels, image, events, events_user)
        return image, s, channels
    if device_entropy and s.compression == Compression.KAGARI and tile_events_mode(events):
        decode_tile_events(view, cursor, grid, s, channels, image, dev, events, events_user)
        return image, s, channels
    if device_entropy and s.compression in (Compression.KAGARI, Compression.MANBAVARAN):
        dispatched = dispatch_tiles_device_entropy(
            view, cursor, grid, s, channels, dev, events, events_user
        )
        # WAVELET covers the wait for each group's device work, FORMAT
        # the pixel download and placement
        for tiles, _th, _tw, pixels in dispatched:
            fire(events, tiles[0].index, total, Event.WAVELET_START, events_user)
            wait_device(pixels)
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


def decode_tiles_iter(blob: bytes, max_batch: int = 32, device=None):
    """Streaming decode (ako_tpu/decode.py:1101): yield (tile placement,
    pixels uint8 (th, tw, channels)) as tile blocks are read, in tile
    row-major order. Every block decodes on its own once the header is
    read, so a truncated blob yields the tiles that fit and then raises
    AkoError. Consecutive same-shaped tiles (a grid row, typically), up to
    `max_batch`, go through one batched unlift on `device` (None means the
    CUDA card, as for decode); the entropy decode runs on the host."""
    dev = resolve_device(device)
    view = memoryview(blob)
    channels, image_w, image_h, s = container.head_read(view)
    _check_decode_budget(image_w, image_h, channels)
    cursor = container.HEAD_SIZE
    pending: list = []

    def flush():
        if not pending:
            return
        t0 = pending[0][0]
        batch = np.stack([v for _, v in pending], axis=0)
        pixels = decode_tiles_device(batch, t0.w, t0.h, channels, s, dev)
        yield from ((t, px) for (t, _), px in zip(pending, pixels))
        pending.clear()

    for t in geometry.tile_grid(image_w, image_h, s.tiles_dimension):
        try:
            values, cursor = read_tile_stream(view, cursor, t, s, channels)
        except AkoError:
            # everything read so far still decodes
            yield from flush()
            raise
        if pending and ((pending[0][0].w, pending[0][0].h) != (t.w, t.h)
                        or len(pending) >= max_batch):
            yield from flush()
        pending.append((t, values))
    yield from flush()

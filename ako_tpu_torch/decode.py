"""Decode orchestrator: .ako blob -> image.

Two paths, as in ako_tpu's decode (ako_tpu/decode.py:974-1043):

- device entropy (the default on the card; ako_tpu/decode.py:732-929):
  the host walks the tile blocks and scans the Kagari payloads for
  per-block sync records, an image's tiles in one native call on native
  threads (scan_blocks, akort_kagari_sync_tiles); per tile-shape group one
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
from ako_tpu_torch.encode import pad_rows, resolve_device, tile_events_mode, tile_stream_bytes
from ako_tpu_torch.ops.colorspace import to_interleaved_u8
from ako_tpu_torch.ops.kagari_device import (
    DECODE_BLOCK,
    DECODE_SLACK_WORDS,
    decode_span_words,
    kagari_decode_device,
)
from ako_tpu_torch.ops.lifting import inverse_tiles
from ako_tpu_torch.ops.manba_device import SYMS, manba_decode_device, span_words
from ako_tpu_torch.parallel.mesh import Caller
from ako_tpu_torch.runtime import hostcodec
from ako_tpu_torch.runtime.kagari import (
    BLOCK_HEAD,
    decompress_block,
    kagari_decode,
    kagari_sync,
    kagari_sync_tiles,
    manba_sync,
)
from ako_tpu_torch.utils import metrics, tracing
from ako_tpu_torch.utils.debug import dev_printf
from ako_tpu_torch.utils.tracing import traced

#: Upper bound on decoded image bytes (w*h*channels). The reference
#: relies on malloc failing for absurd headers (status
#: NO_ENOUGH_MEMORY, encode.c:94-98); reject them before allocating.
MAX_IMAGE_BYTES = 1 << 31


_pool_lock = threading.Lock()
_pool: Optional[ThreadPoolExecutor] = None


def scan_pool() -> ThreadPoolExecutor:
    """Worker threads for the tiles' host sync scans (scan_blocks): an
    image's native Kagari call, or under MANBAVARAN settings a tile a
    task; the native scanners run without the GIL (ctypes calls), as in
    ako_tpu/decode.py:779."""
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


def upload_streams(lane, batch: np.ndarray, key, run=None):
    """A shape group's (T, coeff_count) int16 streams on the host, or the
    run [lo, hi) of them, on the lane's device: one upload, zero streams
    past the group's end."""
    lo, hi = run or (0, len(batch))
    return pad_rows(lane.upload(key, torch.from_numpy(batch[lo:hi])), hi - lo)


def place(image: np.ndarray, tiles, pixels: np.ndarray) -> None:
    """A group's (or a run's) downloaded (T, th, tw, channels) pixels into
    `image` at its tiles; pixels past the tiles (pads) are dropped."""
    for t, pix in zip(tiles, pixels):
        image[t.y : t.y + t.h, t.x : t.x + t.w] = pix


def _with_pool(head: list, items) -> np.ndarray:
    """[base (T) | head's arrays | word pool] as one int32 buffer, the
    head's values as uint32 bit patterns. The pool holds the payloads of
    the (tile, payload, sync record) items word-aligned, tile i from word
    base[i], as big-endian 32-bit words (bit patterns), then
    DECODE_SLACK_WORDS zero words."""
    bases, w = [], 0
    for _, p, _ in items:
        bases.append(w)
        w += (len(p) + 3) // 4
    pool8 = np.zeros((w + DECODE_SLACK_WORDS) * 4, np.uint8)
    for (_, p, _), b in zip(items, bases):
        pool8[b * 4 : b * 4 + len(p)] = np.frombuffer(p, np.uint8)
    head = np.concatenate([np.asarray(a, np.int64).ravel() for a in [bases] + head])
    pool = pool8.view(">u4").astype(np.uint32).view(np.int32)
    return np.concatenate([head.astype(np.uint32).view(np.int32), pool])


def pack_entropy_upload(items) -> tuple:
    """One shape group's device-decode input as one int32 buffer:
    [base (T) | bit_off (T*B) | prev (T*B) | consec (T*B) | run (T*B) |
    word pool] (_with_pool). items: (tile, payload, sync record)
    triples. Returns (buf, T, B)."""
    T, B = len(items), len(items[0][2][0])
    return _with_pool([np.stack([sy[k] for _, _, sy in items]) for k in range(4)], items), T, B


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
    the pool as pack_entropy_upload's (_with_pool). items: (tile,
    payload, manba_sync record) triples. Returns (buf, T, B)."""
    syncs = [sy for _, _, sy in items]
    T, B = len(items), len(syncs[0][0])
    head = [[sy[5] for sy in syncs], [sy[6] for sy in syncs]]
    head += [np.stack([sy[k] for sy in syncs]) for k in range(4)]
    return _with_pool(head, items), T, B


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


def entropy_streams(lane, items, channels: int, s: Settings, manba: bool = False, run=None):
    """A shape group's entropy-coded tiles ((tile, payload, sync record)
    items of scan_blocks), or the run [lo, hi) of them, decoded on the
    lane's device into their (hi - lo, coeff_count) int16 streams,
    enqueued: the payloads and records packed into one buffer, one upload,
    then K4 (Kagari) or K6d (`manba`). Items past the group's end repeat
    its last tile: a valid decode whose output is dropped (zero rows would
    make the decoder chase garbage offsets)."""
    lo, hi = run or (0, len(items))
    items = (items + [items[-1]] * (hi - len(items)))[lo:hi]
    t = items[0][0]
    key = ("manba" if manba else "kagari", t.w, t.h)
    count = tile_block_sizes(t, s, channels)[0] // 2
    # K4 and K6d read the pool; only the plain decoders need windows
    plain = lane.device.type == "cpu"
    if manba:
        buf, T, B = pack_manba_upload(items)
        parts = split_manba_upload(lane.upload(key, torch.from_numpy(buf)), T, B)
        spans = manba_spans(items) if plain else (None, None)
        return manba_decode_device(*parts, count, DECODE_BLOCK, *spans)
    span = max(decode_span_words(sy[0], len(p) * 8) for _, p, sy in items) if plain else None
    buf, T, B = pack_entropy_upload(items)
    parts = split_entropy_upload(lane.upload(key, torch.from_numpy(buf)), T, B)
    return kagari_decode_device(*parts, count, DECODE_BLOCK, span)


def dispatch_entropy(lane, items, channels: int, s: Settings, manba: bool = False, run=None):
    """entropy_streams, then the dequantize, unlift and inverse colour
    (stream_pixels): the group's (or the run's) u8 pixels on the lane's
    device, enqueued."""
    t = items[0][0]
    return stream_pixels(entropy_streams(lane, items, channels, s, manba, run), t.w, t.h,
                         channels, s)


def dispatch_streams(lane, batch: np.ndarray, tw: int, th: int, channels: int, s: Settings, key,
                     run=None):
    """upload_streams, then stream_pixels: the group's (or the run's) u8
    pixels on the lane's device, enqueued."""
    return stream_pixels(upload_streams(lane, batch, key, run), tw, th, channels, s)


def scan_blocks(view, cursor: int, grid, s: Settings, channels: int,
                pool: Optional[ThreadPoolExecutor] = None) -> tuple:
    """The device-entropy decode's host stage: walk the tile blocks, scan
    each payload for its sync records, check that each scan consumed its
    block, and split the tiles. Returns three dicts, each (tw, th) ->
    [(tile, payload, sync record)] in tile order: the Kagari tiles for
    K4, the Manbavaran tiles for K6d, and the quirk tiles (Kagari streams
    with gamma codes over 31 bits, the zigzag(-32768) quirk), which
    decode on the host. Counts the device tiles and the quirk tiles
    (utils/metrics.py). Raises AkoError(BROKEN_INPUT) on a truncated or
    broken block.

    A Kagari image's scans run in one native call (runtime/kagari.py
    kagari_sync_tiles), made from a thread of `pool` (scan_pool() when
    None), on as many native threads as the caller's pool has workers
    (the executor's), else os.cpu_count(), at most one a tile. Under
    MANBAVARAN settings each block is tried as rANS first, then as Kagari
    (reserved-flag blocks holding Kagari bytes fail the rANS magic
    check), one tile a task on the pool, each in a span
    ako.decode.scan_tile."""
    # the block sizes live in the block heads: a sequential walk
    blocks, sizes = [], {}
    for t in grid:
        payload, cursor = read_tile_block(view, cursor, t, s, channels)
        blocks.append((t, payload, cursor - len(payload)))
        if (t.w, t.h) not in sizes:
            sizes[t.w, t.h] = tile_block_sizes(t, s, channels)

    if s.compression == Compression.MANBAVARAN:
        def scan(block):
            t, payload, _ = block
            tds, spacing = sizes[t.w, t.h]
            with tracing.span("ako.decode.scan_tile"):
                ms = manba_sync(tds // 2, payload, DECODE_BLOCK)
                if ms is not None:
                    return "manba", ms
                return "kagari", kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK)

        syncs = list((scan_pool() if pool is None else pool).map(scan, blocks))
    else:
        per_tile = [sizes[t.w, t.h] for t, _, _ in blocks]
        runner = scan_pool() if pool is None else pool
        # ThreadPoolExecutor keeps its width as _max_workers
        width = pool._max_workers if pool is not None else os.cpu_count() or 1
        # made from a pool thread, not the caller's: with the scan on the
        # caller's thread the rest of a whole-tile decode ran slower (p50
        # 25.6 against 23.1 ms on an H100's host), the scan itself not
        found = runner.submit(
            kagari_sync_tiles, view, [off for _, _, off in blocks],
            [len(p) for _, p, _ in blocks], [tds // 2 for tds, _ in per_tile],
            [tds + sp for tds, sp in per_tile], DECODE_BLOCK,
            max(1, min(width, len(blocks)))).result()
        syncs = [("kagari", sync) for sync in found]

    kagari: dict = {}
    manba: dict = {}
    quirk: dict = {}
    for (t, payload, _), (kind, sync) in zip(blocks, syncs):
        # the consumed byte count must be the block's size
        if sync is None or sync[7 if kind == "manba" else 4] != len(payload):
            raise AkoError(Status.BROKEN_INPUT)
        if kind == "manba":
            group = manba
        else:
            group = quirk if sync[5] > 31 else kagari
        group.setdefault((t.w, t.h), []).append((t, payload, sync))
    metrics.bump(metrics.DEC_DEVICE, sum(map(len, kagari.values()))
                 + sum(map(len, manba.values())))
    quirks = sum(map(len, quirk.values()))
    metrics.bump(metrics.DEC_HOST_FALLBACK, quirks)
    if quirks:
        dev_printf("dec: %d/%d quirk streams (gamma codes > 31 bits) decoded on host",
                   quirks, len(grid))
    return kagari, manba, quirk


def quirk_streams(items, s: Settings, channels: int) -> list:
    """The int16 streams of quirk tiles ((tile, payload, sync) items of
    scan_blocks), entropy-decoded on the host."""
    streams = []
    for t, payload, _ in items:
        tds, spacing = tile_block_sizes(t, s, channels)
        res = kagari_decode(tds // 2, payload, tds + spacing)
        if res is None:
            raise AkoError(Status.BROKEN_INPUT)
        streams.append(res[0])
    return streams


def dispatch_tiles_device_entropy(view, cursor: int, grid, s: Settings, channels: int, lane,
                                  events=None, events_user=None,
                                  pool: Optional[ThreadPoolExecutor] = None) -> list:
    """Device-entropy decode, phase 1, on a lane (parallel/mesh.py Shard):
    walk the blocks and scan them for sync records on the host
    (scan_blocks), then per shape group upload, decode, unlift and format
    on the device, enqueued without waiting. Returns (tiles, pixels on the
    device) per group: the Kagari groups, then the Manbavaran ones, then
    the quirk tiles'. `pool` sets the scans' threads (scan_blocks).

    Events as in ako_tpu's fused path: one COMPRESSION pair (tile 0)
    around the walk and the scans, then one per group around its upload
    and dispatch. The walk and the scans are the span ako.decode.scan,
    each tile's scan the span ako.decode.scan_tile on the thread that ran
    it (utils/tracing.py)."""
    total = len(grid)
    fire(events, 0, total, Event.COMPRESSION_START, events_user)
    with tracing.span("ako.decode.scan"):
        kagari, manba, quirk = scan_blocks(view, cursor, grid, s, channels, pool)
    fire(events, 0, total, Event.COMPRESSION_END, events_user)

    dispatched = []
    for kind, groups in (("kagari", kagari), ("manba", manba), ("quirk", quirk)):
        for (tw, th), items in groups.items():
            t0 = items[0][0].index
            fire(events, t0, total, Event.COMPRESSION_START, events_user)
            if kind == "quirk":
                pixels = dispatch_streams(lane, np.stack(quirk_streams(items, s, channels)), tw,
                                          th, channels, s, ("quirk", tw, th))
            else:
                pixels = dispatch_entropy(lane, items, channels, s, manba=kind == "manba")
            fire(events, t0, total, Event.COMPRESSION_END, events_user)
            dispatched.append(([t for t, _, _ in items], pixels))
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
    lane = Caller(device)
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
            coeffs = upload_streams(lane, values[None], ("quirk", t.w, t.h))
        else:
            metrics.bump(metrics.DEC_DEVICE)
            coeffs = entropy_streams(lane, [(t, payload, sync)], channels, s)
        lane.synchronize()
        fire(events, t.index, total, Event.COMPRESSION_END, events_user)
        fire(events, t.index, total, Event.WAVELET_START, events_user)
        pixels = stream_pixels(coeffs, t.w, t.h, channels, s)
        lane.synchronize()
        fire(events, t.index, total, Event.WAVELET_END, events_user)
        fire(events, t.index, total, Event.FORMAT_START, events_user)
        place(image, [t], lane.fetch(("pixels", t.w, t.h), pixels))
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
    lane = Caller(dev)
    if device_entropy and s.compression in (Compression.KAGARI, Compression.MANBAVARAN):
        dispatched = dispatch_tiles_device_entropy(view, cursor, grid, s, channels, lane, events,
                                                   events_user)
        # WAVELET covers the wait for each group's device work, FORMAT
        # the pixel download and placement
        for tiles, _ in dispatched:
            fire(events, tiles[0].index, total, Event.WAVELET_START, events_user)
            lane.synchronize()
            fire(events, tiles[0].index, total, Event.WAVELET_END, events_user)
        for i, (tiles, pixels) in enumerate(dispatched):
            fire(events, tiles[0].index, total, Event.FORMAT_START, events_user)
            place(image, tiles, lane.fetch(("pixels", i), pixels))
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
        pixels = dispatch_streams(lane, np.stack([streams[t.index] for t in tiles]), tw, th,
                                  channels, s, ("streams", tw, th))
        pix = lane.fetch(("pixels", tw, th), pixels)
        fire(events, t0, total, Event.WAVELET_END, events_user)
        fire(events, t0, total, Event.FORMAT_START, events_user)
        place(image, tiles, pix)
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
    lane = Caller(resolve_device(device))
    view = memoryview(blob)
    channels, image_w, image_h, s = container.head_read(view)
    _check_decode_budget(image_w, image_h, channels)
    cursor = container.HEAD_SIZE
    pending: list = []

    def flush():
        if not pending:
            return
        tw, th = pending[0][0].w, pending[0][0].h
        pixels = dispatch_streams(lane, np.stack([v for _, v in pending]), tw, th, channels, s,
                                  ("streams", tw, th))
        pixels = lane.fetch(("pixels", tw, th), pixels)
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

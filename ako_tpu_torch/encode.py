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
- device entropy with MANBAVARAN under AKO_TPU_MANBAVARAN=1
  (ako_tpu/encode.py:792-856): the same upload and lift, then the rANS
  encoder (ops/manba_device.py, kernel K6e); one small record per tile
  comes back, then only the used bytes, and the host frames each payload
  (runtime/kagari.py manba_assemble). A tile that does not fit takes the
  host coder on its stream.
- host entropy (device_entropy=False; ako_tpu/encode.py:333-375 then
  :983-1003): the (T, coeff_count) int16 streams come back once and the
  host coder (akort.c) compresses each tile: Kagari, or rANS for
  MANBAVARAN under AKO_TPU_MANBAVARAN=1 (runtime/kagari.py).

Two modes of ako_tpu are kept: AKO_TPU_ENCODE=host codes every tile with
the native runtime alone (runtime/hostcodec.py), and AKO_TPU_EVENTS=tile
with an events callback runs the device-entropy Kagari path one tile at a
time with the reference's per-tile event pairs. The host assembles the
container. Blob bytes are identical to ako_tpu's and the reference
encoder's for every settings combination.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

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
from ako_tpu_torch.ops.manba_device import manba_encode_device, unpack_record
from ako_tpu_torch.ops.quantization import level_qg
from ako_tpu_torch.parallel.mesh import Caller
from ako_tpu_torch.runtime import hostcodec
from ako_tpu_torch.runtime.kagari import (
    BLOCK_HEAD,
    MANBA_HEAD,
    compress_block,
    effective_method,
    manba_assemble,
)
from ako_tpu_torch.utils import metrics, tracing
from ako_tpu_torch.utils.tracing import traced

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


def host_encode_mode() -> bool:
    """AKO_TPU_ENCODE=host: every tile's colour transform, lift and
    entropy coding run in the native runtime (runtime/hostcodec.py), one
    tile at a time with the reference's per-tile events, and the device
    is not used (ako_tpu/encode.py:65-74)."""
    return os.environ.get("AKO_TPU_ENCODE") == "host"


def tile_events_mode(events) -> bool:
    """AKO_TPU_EVENTS=tile with an events callback: the device-entropy
    Kagari paths run one tile at a time with the reference's per-tile
    event pairs (ako_tpu/encode.py:737-741)."""
    return events is not None and os.environ.get("AKO_TPU_EVENTS") == "tile"


def resolve_device(device) -> torch.device:
    """`None` means the CUDA card; there is no silent CPU fallback. The
    plain torch path runs only when the caller asks for device="cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain torch path")
    return dev


def checked_image(image) -> np.ndarray:
    """The image as a uint8 (h, w, channels) array; (h, w) takes one
    channel. Raises AkoError(INVALID_INPUT) on anything else."""
    if image is None:
        raise AkoError(Status.INVALID_INPUT)
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.dtype != np.uint8:
        raise AkoError(Status.INVALID_INPUT, "expected uint8 (h, w, ch)")
    return image


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


class HostSpanPlan(NamedTuple):
    """Per-(geometry, settings) arrays of the batched native span encoder
    (hostcodec.tile_encode_spans; ako_tpu/encode.py:94): what the C side
    needs per tile, made once and cached, so that an image of the
    executor's AKO_TPU_ENCODE=host route costs one buffer and a join in
    Python. Every array is in tile (wire) order and read-only."""

    rects: np.ndarray  # (n, 4) int32: x, y, w, h
    qg_off: np.ndarray  # (n,) int64 offsets into qs / gs
    qs: np.ndarray  # int32: every tile's quantization steps, one after another
    gs: np.ndarray  # int32: every tile's gate thresholds, likewise
    counts: np.ndarray  # (n,) int64 stream values a tile
    caps: np.ndarray  # (n,) int64 payload capacity bytes a tile
    out_off: np.ndarray  # (n,) int64 start of each block's region in the out buffer
    total_bytes: int  # the out buffer's size: sum(caps + BLOCK_HEAD.size)


@functools.lru_cache(maxsize=64)
def host_span_plan(image_w: int, image_h: int, channels: int, tiles_dimension: int,
                   wavelet: Wavelet, quantization: int, gate: int,
                   chroma_loss: int) -> HostSpanPlan:
    """The span plan of an image geometry (ako_tpu/encode.py:110
    _host_span_plan); each tile's region holds its 4-byte block head and
    its payload capacity, the incompressible bound."""
    grid = geometry.tile_grid(image_w, image_h, tiles_dimension)
    n = len(grid)
    rects = np.empty((n, 4), np.int32)
    qg_off = np.empty(n, np.int64)
    counts = np.empty(n, np.int64)
    caps = np.empty(n, np.int64)
    qs_parts: list = []
    gs_parts: list = []
    by_shape: dict = {}
    off = 0
    for i, t in enumerate(grid):
        rects[i] = (t.x, t.y, t.w, t.h)
        if wavelet == Wavelet.NONE:
            tds = t.w * t.h * channels * 2
            counts[i] = t.w * t.h * channels
            q_arr = g_arr = np.empty(0, np.int32)
        else:
            tds = geometry.tile_data_size(t.w, t.h) * channels
            counts[i] = tds // 2
            if (t.w, t.h) not in by_shape:
                qg = tile_qg(t.w, t.h, channels, quantization, gate, chroma_loss)
                by_shape[(t.w, t.h)] = (
                    np.ascontiguousarray([q for lq, _ in qg for q in lq], dtype=np.int32),
                    np.ascontiguousarray([g for _, lg in qg for g in lg], dtype=np.int32),
                )
            q_arr, g_arr = by_shape[(t.w, t.h)]
        qg_off[i] = off
        off += q_arr.size
        qs_parts.append(q_arr)
        gs_parts.append(g_arr)
        caps[i] = max(0, tds - BLOCK_HEAD.size)
    qs = np.concatenate(qs_parts) if off else np.empty(0, np.int32)
    gs = np.concatenate(gs_parts) if off else np.empty(0, np.int32)
    regions = caps + BLOCK_HEAD.size
    out_off = np.concatenate(([0], np.cumsum(regions[:-1]))).astype(np.int64)
    for a in (rects, qg_off, qs, gs, counts, caps, out_off):
        a.setflags(write=False)
    return HostSpanPlan(rects, qg_off, qs, gs, counts, caps, out_off, int(regions.sum()))


def tile_stream_bytes(t, s: Settings, channels: int) -> int:
    """Bytes of one tile's uncompressed stream: the Kagari block's
    capacity and the raw block's size."""
    if s.wavelet == Wavelet.NONE:
        return t.w * t.h * channels * 2
    return geometry.tile_data_size(t.w, t.h) * channels


def host_block(values: np.ndarray, tile_bytes: int, method: Compression) -> bytes:
    """A tile's block from its int16 stream of `tile_bytes` bytes, made on
    the host: the stream itself under NONE, else the host coder's block
    (compress_block); raises AkoError(ERROR) on an incompressible tile, as
    the reference does."""
    if method == Compression.NONE:
        return values.tobytes()
    block = compress_block(values, tile_bytes, method)
    if block is None:
        raise AkoError(Status.ERROR, "incompressible tile")
    return block


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


# The per-shape-group round trip, written once for every route: the
# one-shot calls (a Caller lane), the streaming executor (its Slots), the
# tile-sharded route (a run of a group on each of a mesh's Shards) and
# rate control. A group function takes the whole group and, on a mesh,
# its shard's run [lo, hi); rows past the group's end are pads, whose
# results are dropped.


def pad_rows(x, rows: int):
    """x with zero rows appended up to `rows`."""
    if x.shape[0] >= rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


def stage_group(lane, batch, fill_val, run=None):
    """A shape group's u8 tiles cut from the lane's source (stage_tiles of
    Shard.source), or the run [lo, hi) of them, on the lane's device as
    (hi - lo, th, tw, channels): zero tiles past the group's end, and the
    constant last channel `fill_val` put back."""
    lo, hi = run or (0, len(batch))
    x = pad_rows(lane.stage(batch[lo:hi]), hi - lo)
    if fill_val is None:
        return x
    return torch.cat([x, x.new_full(x.shape[:-1] + (1,), fill_val)], dim=-1)


def dispatch_group(lane, tiles, tiles_dev, channels: int, s: Settings, run=None,
                   entropy: bool = True) -> tuple:
    """A shape group's staged u8 tiles (stage_group), or a run's, through
    the device, enqueued: the colour transform, lift and quantize/gate
    (forward_streams), then the entropy coder (entropy_group). Without
    `entropy` the host frames the blocks (raw blocks, the host coder) and
    the record is (real tiles, streams on the device)."""
    stream = forward_streams(tiles_dev, tiles[0].w, tiles[0].h, channels, s)
    if not entropy:
        lo, hi = run or (0, len(tiles))
        return tiles[lo:hi], stream
    return entropy_group(lane, tiles, stream, channels, s, run)


def entropy_group(lane, tiles, stream, channels: int, s: Settings, run=None) -> tuple:
    """A shape group's entropy stage on its (T, n) int16 streams on the
    lane's device, enqueued: K6e under the MANBAVARAN extension, else K3
    at the pack budget; the (T,) totals' (K6e: the records') download
    started on the lane (Shard.prefetch). Given a run [lo, hi), the
    streams are the run's and its real tiles the group's tiles[lo:hi].
    Returns the record collect_tiles_blocks (collect_tiles_manba) frames;
    the streams stay on the device for the host coder's fallback, so no
    tile is lifted twice."""
    lo, hi = run or (0, len(tiles))
    tw, th = tiles[0].w, tiles[0].h
    capacity = tile_stream_bytes(tiles[0], s, channels) - BLOCK_HEAD.size
    if effective_method(s.compression) == Compression.MANBAVARAN:
        record, rans, extras = manba_encode_device(stream, capacity)
        record = lane.prefetch(("record", tw, th), record)
        return tiles[lo:hi], stream, record, rans, extras, capacity
    budget = pack_budget(capacity, s.quantization)
    comp, totals = kagari_encode_device(stream, capacity, budget)
    return tiles[lo:hi], stream, comp, lane.prefetch(("totals", tw, th), totals), capacity, budget


def encode_tiles_device(
    image: np.ndarray,
    s: Settings,
    device: torch.device,
    events: Optional[EventsCallback] = None,
    events_user=None,
) -> list:
    """Run the device stage for every tile; returns a list of int16
    numpy coefficient streams in tile (row-major) order."""
    lane = Caller(device)
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    src, fill_val = lane.source(image)

    out: list = [None] * total
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        t0 = tiles[0].index
        fire(events, t0, total, Event.FORMAT_START, events_user)
        tiles_dev = stage_group(lane, stage_tiles(src, tiles, tw, th), fill_val)
        fire(events, t0, total, Event.FORMAT_END, events_user)
        fire(events, t0, total, Event.WAVELET_START, events_user)
        _, stream = dispatch_group(lane, tiles, tiles_dev, channels, s, entropy=False)
        coeffs = lane.fetch(("streams", tw, th), stream)
        fire(events, t0, total, Event.WAVELET_END, events_user)
        for i, t in enumerate(tiles):
            out[t.index] = coeffs[i]
    return out


def fallback_streams(lane, stream, fallback: np.ndarray, key) -> np.ndarray:
    """The (len(fallback), n) int16 streams of a shape group's tiles at
    the indices `fallback`, on the host, for the host coder."""
    index = lane.upload(key + ("index",), torch.from_numpy(fallback))
    return lane.fetch(key, stream[index])


def dispatch_tiles_fused(
    image: np.ndarray,
    s: Settings,
    lane,
    events: Optional[EventsCallback] = None,
    events_user=None,
) -> tuple:
    """Device-entropy encode, phase 1, on a lane (parallel/mesh.py Shard):
    per shape group the staging (stage_group), then colour + lift +
    quantize/gate + tokenize/pack on the device (dispatch_group),
    enqueued without waiting. Returns (grid, per-group records).

    Events fire per shape group (tile_no = the group's first tile), as
    in ako_tpu's fused path: FORMAT covers the group's staging. The
    lane's source runs before the first of them, under the span
    ako.encode.source, and the whole phase is the span
    ako.encode.dispatch (utils/tracing.py): what it holds beyond those two
    is the groups' bookkeeping and the launches."""
    with tracing.span("ako.encode.dispatch"):
        image_h, image_w, channels = image.shape
        grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
        total = len(grid)
        with tracing.span("ako.encode.source"):
            src, fill_val = lane.source(image)

        dispatched = []
        for (tw, th), tiles in geometry.group_by_shape(grid).items():
            t0 = tiles[0].index
            fire(events, t0, total, Event.FORMAT_START, events_user)
            tiles_dev = stage_group(lane, stage_tiles(src, tiles, tw, th), fill_val)
            fire(events, t0, total, Event.FORMAT_END, events_user)
            dispatched.append(dispatch_group(lane, tiles, tiles_dev, channels, s))
        return grid, dispatched


def collect_tiles_blocks(grid, dispatched, lane, events=None, events_user=None) -> list:
    """Device-entropy encode, phase 2, on the lane that dispatched them:
    per shape group one download of the (T,) totals and one of the
    compressed rows, cut at the group's largest total; frame the blocks.
    Tiles over the budget or within _CAPACITY_MARGIN of the capacity take
    the host coder on their stream, and both kinds are counted
    (utils/metrics.py). A run's pad rows are not read.

    WAVELET covers the wait for the group's device work, COMPRESSION
    the byte download and framing."""
    total = len(grid)
    out: list = [None] * total
    for tiles, stream, comp, totals_t, capacity, budget in dispatched:
        t0 = tiles[0].index
        tw, th = tiles[0].w, tiles[0].h
        fire(events, t0, total, Event.WAVELET_START, events_user)
        totals = totals_t.cpu().numpy()[: len(tiles)]
        fire(events, t0, total, Event.WAVELET_END, events_user)
        fire(events, t0, total, Event.COMPRESSION_START, events_user)
        past = (totals > budget) | (totals >= capacity - _CAPACITY_MARGIN)
        ok = np.flatnonzero(~past)
        fallback = np.flatnonzero(past)
        metrics.bump(metrics.ENC_DEVICE, len(ok))
        metrics.bump(metrics.ENC_HOST_FALLBACK, len(fallback))
        if len(ok):
            rows = lane.fetch(("rows", tw, th), comp[: len(tiles), : int(totals[ok].max())])
            for i in ok:
                n = int(totals[i])
                out[tiles[i].index] = BLOCK_HEAD.pack(n) + rows[i, :n].tobytes()
        if len(fallback):
            streams = fallback_streams(lane, stream, fallback, ("fallback", tw, th))
            for values, i in zip(streams, fallback):
                out[tiles[i].index] = host_block(values, capacity + BLOCK_HEAD.size,
                                                 Compression.KAGARI)
        fire(events, t0, total, Event.COMPRESSION_END, events_user)
    return out


def _dispatch_manba_group(lane, src, fill_val, tiles, channels: int, s: Settings, total: int,
                          events, events_user) -> tuple:
    """One shape group of dispatch_tiles_manba: the staging, the lift and
    K6e enqueued; FORMAT around the staging, WAVELET opened before the
    device work."""
    tw, th = tiles[0].w, tiles[0].h
    t0 = tiles[0].index
    fire(events, t0, total, Event.FORMAT_START, events_user)
    tiles_dev = stage_group(lane, stage_tiles(src, tiles, tw, th), fill_val)
    fire(events, t0, total, Event.FORMAT_END, events_user)
    fire(events, t0, total, Event.WAVELET_START, events_user)
    return dispatch_group(lane, tiles, tiles_dev, channels, s)


def _collect_manba_group(lane, group: tuple, s: Settings, out: list, total: int, events,
                         events_user) -> None:
    """One shape group of collect_tiles_manba into `out`: the record on
    the host closes WAVELET; COMPRESSION around the byte download and the
    framing."""
    tiles, stream, record, rans, extras, capacity = group
    tw, th = tiles[0].w, tiles[0].h
    t0 = tiles[0].index
    freq, x, rbytes, ebits, ok = unpack_record(record)
    fire(events, t0, total, Event.WAVELET_END, events_user)
    fire(events, t0, total, Event.COMPRESSION_START, events_user)
    ebytes = (ebits + 7) // 8
    fits = ok & (MANBA_HEAD.size + rbytes + ebytes <= capacity)
    use = np.flatnonzero(fits)
    fallback = np.flatnonzero(~fits)
    if len(use):
        rw, ew = int(rbytes[use].max()), int(ebytes[use].max())
        rans_tail = lane.fetch(("rans", tw, th), rans[:, capacity - rw :])
        extras_head = lane.fetch(("extras", tw, th), extras[:, :ew])
        for i in use:
            payload = manba_assemble(freq[i], x[i], rans_tail[i, rw - rbytes[i] :], rbytes[i],
                                     extras_head[i], ebits[i], ok[i], capacity)
            out[tiles[i].index] = BLOCK_HEAD.pack(len(payload)) + payload
    if len(fallback):
        streams = fallback_streams(lane, stream, fallback, ("fallback", tw, th))
        for values, i in zip(streams, fallback):
            out[tiles[i].index] = host_block(values, capacity + BLOCK_HEAD.size, s.compression)
    metrics.bump(metrics.ENC_DEVICE, len(use))
    metrics.bump(metrics.ENC_HOST_FALLBACK, len(fallback))
    fire(events, t0, total, Event.COMPRESSION_END, events_user)


def dispatch_tiles_manba(image: np.ndarray, s: Settings, lane) -> tuple:
    """Device-entropy encode for the MANBAVARAN extension, phase 1
    (ako_tpu/encode.py:792-856), on a lane: per shape group the staging,
    the colour transform, lift and quantize/gate (forward_streams), then
    the rANS encoder (manba_encode_device, kernel K6e), enqueued without
    waiting, the (T, RECORD_WORDS) records' download started. Returns
    (grid, per-group records)."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    src, fill_val = lane.source(image)
    return grid, [
        _dispatch_manba_group(lane, src, fill_val, tiles, channels, s, len(grid), None, None)
        for tiles in geometry.group_by_shape(grid).values()
    ]


def collect_tiles_manba(grid, dispatched, s: Settings, lane) -> list:
    """Phase 2, on the lane that dispatched them: per shape group the
    record comes back, then only the used bytes (the group's longest rANS
    tail and extras head); the host frames each payload (manba_assemble).
    A tile whose payload does not fit its capacity takes the host coder on
    its stream; both kinds are counted (utils/metrics.py)."""
    out: list = [None] * len(grid)
    for group in dispatched:
        _collect_manba_group(lane, group, s, out, len(grid), None, None)
    return out


def encode_tiles_blocks_manba(image: np.ndarray, s: Settings, device: torch.device,
                              events=None, events_user=None) -> list:
    """dispatch_tiles_manba and collect_tiles_manba in a row, one shape
    group at a time, so that the events keep ako_tpu's per-group order:
    FORMAT around the staging, WAVELET around the device work up to the
    record, COMPRESSION around the byte download and framing."""
    lane = Caller(device)
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    src, fill_val = lane.source(image)
    out: list = [None] * len(grid)
    for tiles in geometry.group_by_shape(grid).values():
        group = _dispatch_manba_group(lane, src, fill_val, tiles, channels, s, len(grid), events,
                                      events_user)
        _collect_manba_group(lane, group, s, out, len(grid), events, events_user)
    return out


def encode_tiles_blocks_tile_events(image: np.ndarray, s: Settings, device: torch.device,
                                    events, events_user) -> list:
    """The device-entropy Kagari encode one tile at a time, with the
    reference's per-tile event pairs (ako.h:75-84; ako_tpu/encode.py:
    674-734): FORMAT around the staging, WAVELET around the lift,
    COMPRESSION around the pack, its download and the framing; each stage
    boundary waits for the device. A tracing mode: the same blocks as the
    batched path, at the cost of one dispatch a tile."""
    lane = Caller(device)
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    src, fill_val = lane.source(image)
    out = []
    for t in grid:
        fire(events, t.index, total, Event.FORMAT_START, events_user)
        tiles_dev = stage_group(lane, stage_tiles(src, [t], t.w, t.h), fill_val)
        lane.synchronize()
        fire(events, t.index, total, Event.FORMAT_END, events_user)
        fire(events, t.index, total, Event.WAVELET_START, events_user)
        stream = forward_streams(tiles_dev, t.w, t.h, channels, s)
        lane.synchronize()
        fire(events, t.index, total, Event.WAVELET_END, events_user)
        fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        record = entropy_group(lane, [t], stream, channels, s)
        out.append(collect_tiles_blocks(grid, [record], lane)[t.index])
        fire(events, t.index, total, Event.COMPRESSION_END, events_user)
    return out


def encode_tiles_host(image: np.ndarray, s: Settings, events=None, events_user=None,
                      tiles=None) -> list:
    """AKO_TPU_ENCODE=host: every tile through the native runtime, with
    the reference's per-tile events (ako_tpu/encode.py:924-960): FORMAT
    around the colour transform, WAVELET around the lift, COMPRESSION
    around the entropy coder. Returns the blocks in tile order; `tiles`,
    a part of the image's grid, codes only those (the executor's span of
    a worker thread)."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    blocks = []
    for t in grid if tiles is None else tiles:
        tile = image[t.y : t.y + t.h, t.x : t.x + t.w, :]
        fire(events, t.index, total, Event.FORMAT_START, events_user)
        planes = hostcodec.u8_to_planes(tile, s.color, bool(s.discard_non_visible))
        fire(events, t.index, total, Event.FORMAT_END, events_user)
        fire(events, t.index, total, Event.WAVELET_START, events_user)
        if s.wavelet == Wavelet.NONE:
            stream = np.ascontiguousarray(planes).reshape(-1)
        else:
            qg = tile_qg(t.w, t.h, channels, s.quantization, s.gate, s.chroma_loss)
            stream = hostcodec.tile_lift(planes, s.wavelet, s.wrap, qg)
        fire(events, t.index, total, Event.WAVELET_END, events_user)
        fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        blocks.append(host_block(stream, tile_stream_bytes(t, s, channels), s.compression))
        fire(events, t.index, total, Event.COMPRESSION_END, events_user)
    return blocks


@traced
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
    backend. `events` is the per-stage tracing hook (core.events);
    AKO_TPU_EVENTS=tile makes the device-entropy Kagari path fire it per
    tile. AKO_TPU_ENCODE=host codes every tile in the native runtime."""
    image = checked_image(image)
    dev = resolve_device(device)
    if device_entropy is None:
        device_entropy = dev.type == "cuda"

    s = checked_settings(settings)
    image_h, image_w, channels = image.shape
    head = container.head_write(channels, image_w, image_h, s)
    if host_encode_mode():
        return head + b"".join(encode_tiles_host(image, s, events, events_user))
    method = effective_method(s.compression)

    if device_entropy and method == Compression.MANBAVARAN:
        return head + b"".join(encode_tiles_blocks_manba(image, s, dev, events, events_user))
    if device_entropy and method == Compression.KAGARI:
        # KAGARI and the reserved MANBAVARAN flag (Kagari bytes)
        if tile_events_mode(events):
            return head + b"".join(
                encode_tiles_blocks_tile_events(image, s, dev, events, events_user))
        lane = Caller(dev)
        grid, dispatched = dispatch_tiles_fused(image, s, lane, events, events_user)
        return head + b"".join(collect_tiles_blocks(grid, dispatched, lane, events, events_user))

    streams = encode_tiles_device(image, s, dev, events, events_user)
    blocks = [head]
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    for t, values in zip(grid, streams):
        fire(events, t.index, len(grid), Event.COMPRESSION_START, events_user)
        blocks.append(host_block(values, tile_stream_bytes(t, s, channels), s.compression))
        fire(events, t.index, len(grid), Event.COMPRESSION_END, events_user)
    return b"".join(blocks)

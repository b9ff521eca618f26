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
from ako_tpu_torch.runtime import hostcodec
from ako_tpu_torch.runtime.kagari import (
    BLOCK_HEAD,
    MANBA_HEAD,
    compress_block,
    effective_method,
    manba_assemble,
)
from ako_tpu_torch.utils import metrics
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


def to_device(t, device, host=None, key=None):
    """The host tensor t on `device`: a plain copy, or, given an executor
    slot `host` (runtime/executor.py Slot), a copy through the slot's
    pinned buffer `key`, enqueued on its stream without waiting."""
    return t.to(device) if host is None else host.upload(key, t, device)


def to_host(t, host=None, key=None) -> np.ndarray:
    """The device tensor t as a host array, once the device has made it: a
    plain copy, or, given an executor slot `host`, a copy through the
    slot's pinned buffer `key` on its stream."""
    if host is None:
        return t.cpu().numpy()
    out = host.download(key, t)
    host.sync()
    return out.numpy()


def fallback_streams(stream, fallback: np.ndarray, host=None, key=None) -> np.ndarray:
    """The (len(fallback), n) int16 streams of a shape group's tiles at
    the indices `fallback`, on the host, for the host coder."""
    index = to_device(torch.from_numpy(fallback), stream.device, host,
                      None if host is None else key + ("index",))
    return to_host(stream[index], host, key)


def staging_source(image: np.ndarray, device=None, host=None) -> tuple:
    """(src, fill_val): the image as a tensor to stage tiles from, without
    its constant last channel when it has one (image_fill_val), which
    with_fill puts back on the device. Given an executor slot `host`,
    the whole image instead, on `device` through the slot's pinned buffer
    in one contiguous copy, and no fill: the tiles are then cut on the
    device, so the host's work is that copy alone (no strided gather and
    no compare of the last channel, both torch ops whose intra-op threads
    would take cores from the other images' host work)."""
    image = np.ascontiguousarray(image)  # torch takes no negative strides
    if host is not None:
        return host.upload("image", torch.from_numpy(image), device), None
    fill_val = image_fill_val(image)
    src = torch.from_numpy(image)
    return (src if fill_val is None else src[..., :-1]), fill_val


def with_fill(tiles_dev, fill_val):
    """The staged tiles with their constant last channel appended on the
    device (no-op when fill_val is None)."""
    if fill_val is None:
        return tiles_dev
    last = tiles_dev.new_full(tiles_dev.shape[:-1] + (1,), fill_val)
    return torch.cat([tiles_dev, last], dim=-1)


def dispatch_tiles_fused(
    image: np.ndarray,
    s: Settings,
    device: torch.device,
    events: Optional[EventsCallback] = None,
    events_user=None,
    host=None,
) -> tuple:
    """Device-entropy encode, phase 1: per shape group one u8 upload,
    then colour + lift + quantize/gate + tokenize/pack on the device,
    enqueued without waiting. Returns (grid, per-group records). Given an
    executor slot `host`, the upload goes through its pinned buffers and
    the totals' download is enqueued too (collect_tiles_blocks with the
    same slot reads them).

    Events fire per shape group (tile_no = the group's first tile), as
    in ako_tpu's fused path: FORMAT covers host staging + upload."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    src, fill_val = staging_source(image, device, host)

    dispatched = []
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        capacity = tile_stream_bytes(tiles[0], s, channels) - BLOCK_HEAD.size
        budget = pack_budget(capacity, s.quantization)
        t0 = tiles[0].index
        fire(events, t0, total, Event.FORMAT_START, events_user)
        tiles_dev = stage_tiles(src, tiles, tw, th).to(device)
        fire(events, t0, total, Event.FORMAT_END, events_user)
        # the stream stays on the device for the near-capacity fallback,
        # so no tile is lifted twice
        stream = forward_streams(with_fill(tiles_dev, fill_val), tw, th, channels, s)
        comp, totals = kagari_encode_device(stream, capacity, budget)
        if host is not None:
            totals = host.download(("totals", tw, th), totals)
        dispatched.append((tiles, stream, comp, totals, capacity, budget))
    return grid, dispatched


def collect_tiles_blocks(grid, dispatched, events=None, events_user=None, host=None) -> list:
    """Device-entropy encode, phase 2: per shape group one download of
    the (T,) totals and one of the compressed rows, cut at the group's
    largest total; frame the blocks. Tiles over the budget or within
    _CAPACITY_MARGIN of the capacity take the host coder on their
    stream, and both kinds are counted (utils/metrics.py). Given the
    executor slot that dispatched them, it first waits for the slot's
    dispatch (the totals are then on the host) and downloads through the
    slot's pinned buffers on its stream.

    WAVELET covers the wait for the group's device work, COMPRESSION
    the byte download and framing."""
    total = len(grid)
    out: list = [None] * total
    if host is not None:
        host.wait()
    for tiles, stream, comp, totals_t, capacity, budget in dispatched:
        t0 = tiles[0].index
        tw, th = tiles[0].w, tiles[0].h
        fire(events, t0, total, Event.WAVELET_START, events_user)
        totals = totals_t.cpu().numpy()
        fire(events, t0, total, Event.WAVELET_END, events_user)
        fire(events, t0, total, Event.COMPRESSION_START, events_user)
        past = (totals > budget) | (totals >= capacity - _CAPACITY_MARGIN)
        ok = np.flatnonzero(~past)
        fallback = np.flatnonzero(past)
        metrics.bump(metrics.ENC_DEVICE, len(ok))
        metrics.bump(metrics.ENC_HOST_FALLBACK, len(fallback))
        if len(ok):
            rows = to_host(comp[:, : int(totals[ok].max())], host, ("rows", tw, th))
            for i in ok:
                n = int(totals[i])
                out[tiles[i].index] = BLOCK_HEAD.pack(n) + rows[i, :n].tobytes()
        if len(fallback):
            streams = fallback_streams(stream, fallback, host, ("fallback", tw, th))
            for values, i in zip(streams, fallback):
                block = compress_block(values, capacity + BLOCK_HEAD.size)
                if block is None:
                    raise AkoError(Status.ERROR, "incompressible tile")
                out[tiles[i].index] = block
        fire(events, t0, total, Event.COMPRESSION_END, events_user)
    return out


def _dispatch_manba_group(src, fill_val, tiles, channels: int, s: Settings, device, total: int,
                          events, events_user, host) -> tuple:
    """One shape group of dispatch_tiles_manba: the u8 upload, the lift
    and K6e enqueued; FORMAT around the staging and upload, WAVELET
    opened before the device work."""
    tw, th = tiles[0].w, tiles[0].h
    capacity = tile_stream_bytes(tiles[0], s, channels) - BLOCK_HEAD.size
    t0 = tiles[0].index
    fire(events, t0, total, Event.FORMAT_START, events_user)
    tiles_dev = stage_tiles(src, tiles, tw, th).to(device)
    fire(events, t0, total, Event.FORMAT_END, events_user)
    fire(events, t0, total, Event.WAVELET_START, events_user)
    stream = forward_streams(with_fill(tiles_dev, fill_val), tw, th, channels, s)
    record, rans, extras = manba_encode_device(stream, capacity)
    if host is not None:
        record = host.download(("record", tw, th), record)
    return tiles, stream, record, rans, extras, capacity


def _collect_manba_group(group: tuple, s: Settings, out: list, total: int, events, events_user,
                         host) -> None:
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
        rans_tail = to_host(rans[:, capacity - rw :], host, ("rans", tw, th))
        extras_head = to_host(extras[:, :ew], host, ("extras", tw, th))
        for i in use:
            payload = manba_assemble(freq[i], x[i], rans_tail[i, rw - rbytes[i] :], rbytes[i],
                                     extras_head[i], ebits[i], ok[i], capacity)
            out[tiles[i].index] = BLOCK_HEAD.pack(len(payload)) + payload
    if len(fallback):
        streams = fallback_streams(stream, fallback, host, ("fallback", tw, th))
        for values, i in zip(streams, fallback):
            block = compress_block(values, capacity + BLOCK_HEAD.size, s.compression)
            if block is None:
                raise AkoError(Status.ERROR, "incompressible tile")
            out[tiles[i].index] = block
    metrics.bump(metrics.ENC_DEVICE, len(use))
    metrics.bump(metrics.ENC_HOST_FALLBACK, len(fallback))
    fire(events, t0, total, Event.COMPRESSION_END, events_user)


def dispatch_tiles_manba(image: np.ndarray, s: Settings, device: torch.device,
                         host=None) -> tuple:
    """Device-entropy encode for the MANBAVARAN extension, phase 1
    (ako_tpu/encode.py:792-856): per shape group one u8 upload, the
    colour transform, lift and quantize/gate (forward_streams), then the
    rANS encoder (manba_encode_device, kernel K6e), enqueued without
    waiting. Returns (grid, per-group records). Given an executor slot
    `host`, the upload goes through its pinned buffers and the (T,
    RECORD_WORDS) records' download is enqueued too."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    src, fill_val = staging_source(image, device, host)
    return grid, [
        _dispatch_manba_group(src, fill_val, tiles, channels, s, device, len(grid), None, None,
                              host)
        for tiles in geometry.group_by_shape(grid).values()
    ]


def collect_tiles_manba(grid, dispatched, s: Settings, host=None) -> list:
    """Phase 2: per shape group the record comes back, then only the used
    bytes (the group's longest rANS tail and extras head); the host frames
    each payload (manba_assemble). A tile whose payload does not fit its
    capacity takes the host coder on its stream; both kinds are counted
    (utils/metrics.py). Given the executor slot that dispatched them, it
    first waits for the slot's dispatch and downloads through the slot's
    pinned buffers on its stream."""
    if host is not None:
        host.wait()
    out: list = [None] * len(grid)
    for group in dispatched:
        _collect_manba_group(group, s, out, len(grid), None, None, host)
    return out


def encode_tiles_blocks_manba(image: np.ndarray, s: Settings, device: torch.device,
                              events=None, events_user=None) -> list:
    """dispatch_tiles_manba and collect_tiles_manba in a row, one shape
    group at a time, so that the events keep ako_tpu's per-group order:
    FORMAT around staging and upload, WAVELET around the device work up
    to the record, COMPRESSION around the byte download and framing."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    src, fill_val = staging_source(image)
    out: list = [None] * len(grid)
    for tiles in geometry.group_by_shape(grid).values():
        group = _dispatch_manba_group(src, fill_val, tiles, channels, s, device, len(grid), events,
                                      events_user, None)
        _collect_manba_group(group, s, out, len(grid), events, events_user, None)
    return out


def wait_device(t, stream=None) -> None:
    """Block the host until the device work that made t is done: the work
    queued so far on `stream`, by default the current stream of t's
    device in this thread, where the port's calls enqueue (an executor
    waiting from another thread names its slot's stream). It waits on an
    event recorded there, so work queued later, on that stream or any
    other, is not waited for. Nothing on the CPU."""
    if t.is_cuda:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device) if stream is None else stream)
        done.synchronize()


def encode_tiles_blocks_tile_events(image: np.ndarray, s: Settings, device: torch.device,
                                    events, events_user) -> list:
    """The device-entropy Kagari encode one tile at a time, with the
    reference's per-tile event pairs (ako.h:75-84; ako_tpu/encode.py:
    674-734): FORMAT around staging and upload, WAVELET around the lift,
    COMPRESSION around the pack, its download and the framing; each stage
    boundary waits for the device. A tracing mode: the same blocks as the
    batched path, at the cost of one dispatch a tile."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    total = len(grid)
    src = torch.from_numpy(np.ascontiguousarray(image))
    out = []
    for t in grid:
        capacity = tile_stream_bytes(t, s, channels) - BLOCK_HEAD.size
        budget = pack_budget(capacity, s.quantization)
        fire(events, t.index, total, Event.FORMAT_START, events_user)
        tiles_dev = stage_tiles(src, [t], t.w, t.h).to(device)
        wait_device(tiles_dev)
        fire(events, t.index, total, Event.FORMAT_END, events_user)
        fire(events, t.index, total, Event.WAVELET_START, events_user)
        stream = forward_streams(tiles_dev, t.w, t.h, channels, s)
        wait_device(stream)
        fire(events, t.index, total, Event.WAVELET_END, events_user)
        fire(events, t.index, total, Event.COMPRESSION_START, events_user)
        comp, totals = kagari_encode_device(stream, capacity, budget)
        n = int(totals[0])
        if n > budget or n >= capacity - _CAPACITY_MARGIN:
            metrics.bump(metrics.ENC_HOST_FALLBACK)
            block = compress_block(stream[0].cpu().numpy(), capacity + BLOCK_HEAD.size)
            if block is None:
                raise AkoError(Status.ERROR, "incompressible tile")
        else:
            metrics.bump(metrics.ENC_DEVICE)
            block = BLOCK_HEAD.pack(n) + comp[0, :n].cpu().numpy().tobytes()
        out.append(block)
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
        if s.compression == Compression.NONE:
            blocks.append(stream.tobytes())
        else:
            block = compress_block(stream, tile_stream_bytes(t, s, channels), s.compression)
            if block is None:
                raise AkoError(Status.ERROR, "incompressible tile")
            blocks.append(block)
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

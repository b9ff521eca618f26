"""Streaming executor: encode and decode a stream of images with several
images in flight, so that one image's host work overlaps the next
image's device work. The port of ako_tpu/runtime/executor.py, with the
same public names and arguments and one more, `device`: None means the
CUDA card and raises when there is none, "cpu" the plain torch path (no
streams, plain buffers), as the tests run it.

On the card every in-flight image holds a slot (Slot): a CUDA stream of
its own and host buffers, pinned, made once per key and size and reused
by each image that takes the slot. An image's dispatch runs on the
calling thread under its slot's stream: the staged upload, the lift and
the entropy kernels and the first downloads, all enqueued without
waiting, closed by an event. Its collect runs on an IO thread under the
same stream, after that event: the downloads that depend on what came
back, the host coder's fallbacks and the framing (encode), or the pixel
placement (decode). So:

- encode: image k+1 is staged and dispatched while image k's bytes come
  back and its blocks are framed on the IO threads;
- decode: image k+1's block walk and sync scans run on the worker pool
  while image k's K4 or K6d, unlift and pixel download run on its slot;
- roundtrip_iter: the encoder runs on a thread of its own and feeds the
  decoder through a bounded queue.

Two threads may then launch on the card at once, each on its own
streams; the kernel wrappers' launch counters and K3's scratch are
locked for that (runtime/kernels.py count_launch, ops/kagari_device.py
encode_scratch).

Routes, as ako_tpu's (executor.py:94-355, :436-541):
- encode, AKO_TPU_ENCODE=host: the native span encoder on the worker
  pool, AKO_ENC_INFLIGHT images in flight (3 by default); non-Kagari
  methods per tile;
- encode, device entropy (Kagari, and MANBAVARAN under
  AKO_TPU_MANBAVARAN=1 with K6e, as the port's encode routes them):
  per image, AKO_ENC_INFLIGHT in flight (5 by default);
- encode, host entropy: the device lift with blocking copies, then the
  host coder on the worker pool while the next image's lift runs;
- decode, AKO_TPU_DECODE=host: the native span decoder (Kagari) or per
  tile, on the worker pool; device entropy: encode.py's twin,
  decode.dispatch_tiles_device_entropy with its scans on the worker
  pool; host entropy: the entropy decode on the worker pool, then the
  unlift on the slot.

Not ported, since they exist for the TPU's tunnelled link (ROADMAP.md,
"Do not port"): the coalescing route (ako_tpu's AKO_ENC_COALESCE > 1,
encode.dispatch_images_fused / collect_images_blobs; the port reads no
AKO_ENC_COALESCE), and the resident-row reuse (keep_residue,
AKO_TPU_RESIDENT): encode_iter(keep_residue=True) yields (blob, None)
pairs and decode_iter(paired=True) ignores the residue, so that code
written against ako_tpu's API runs unchanged.
"""

from __future__ import annotations

import concurrent.futures as cf
import contextlib
import math
import os
import queue
import threading
from collections import deque
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ako_tpu_torch.core import container, geometry
from ako_tpu_torch.core.settings import AkoError, Compression, Settings, Status
from ako_tpu_torch.decode import (
    _check_decode_budget,
    dispatch_tiles_device_entropy,
    host_decode_mode,
    host_decode_plan,
    read_tile_block,
    read_tile_stream,
    stream_pixels,
)
from ako_tpu_torch.encode import (
    checked_image,
    checked_settings,
    collect_tiles_blocks,
    collect_tiles_manba,
    dispatch_tiles_fused,
    dispatch_tiles_manba,
    encode_tiles_device,
    encode_tiles_host,
    host_encode_mode,
    host_span_plan,
    resolve_device,
    tile_stream_bytes,
    to_device,
)
from ako_tpu_torch.runtime import hostcodec
from ako_tpu_torch.runtime.kagari import BLOCK_HEAD, compress_block, effective_method


def _inflight(default: int) -> int:
    """AKO_ENC_INFLIGHT: the encoder's images in flight."""
    return max(1, int(os.environ.get("AKO_ENC_INFLIGHT", str(default))))


class Slot:
    """One in-flight image's CUDA stream and host buffers. On the card the
    buffers are pinned, so that the copies through them run on the slot's
    stream while the host goes on, and the slot's waits sleep (blocking
    events) instead of spinning on a core that the other images' sync
    scans need; on the CPU the slot has no stream and its
    buffers are plain. Encode and decode take a slot as their `host`
    argument (encode.to_device, encode.to_host)."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.dispatched = torch.cuda.Event(blocking=True) if cuda else None
        self._buffers: dict = {}

    def use(self):
        """The context in which this thread's device work goes to the
        slot's stream."""
        return contextlib.nullcontext() if self.stream is None else torch.cuda.stream(self.stream)

    def buffer(self, key, shape, dtype) -> torch.Tensor:
        """The host buffer `key` as a tensor of `shape` and `dtype`: made at
        first use and again, a quarter larger than asked, when a call
        needs more than it holds (upload sizes vary from image to image),
        else reused."""
        n = math.prod(shape)
        buf = self._buffers.get(key)
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            buf = torch.empty(n + n // 4, dtype=dtype, pin_memory=self.stream is not None)
            self._buffers[key] = buf
        return buf[:n].view(shape)

    def upload(self, key, t: torch.Tensor, device) -> torch.Tensor:
        """The host tensor t on `device` through the buffer `key`, the copy
        to the device enqueued on the current stream (the slot's, under
        use()). numpy copies t into the buffer: torch's copy would run on
        its intra-op threads, which then spin on cores that the other
        images' sync scans need."""
        buf = self.buffer(key, t.shape, t.dtype)
        buf.numpy()[...] = t.numpy()
        return buf.to(device, non_blocking=True)

    def download(self, key, t: torch.Tensor) -> torch.Tensor:
        """The device tensor t into the buffer `key`, the copy enqueued on
        the current stream; read the buffer after sync()."""
        buf = self.buffer(key, t.shape, t.dtype)
        buf.copy_(t, non_blocking=True)
        return buf

    def record(self) -> None:
        """Close the dispatch: an event after its work on the slot's stream."""
        if self.stream is not None:
            self.dispatched.record(self.stream)

    def wait(self) -> None:
        """Block until the dispatch's work and copies are done."""
        if self.stream is not None:
            self.dispatched.synchronize()

    def sync(self) -> None:
        """Block until the work enqueued on the slot's stream so far is done."""
        if self.stream is not None:
            done = torch.cuda.Event(blocking=True)
            done.record(self.stream)
            done.synchronize()


def _pipeline(items: Iterable, dispatch: Callable, collect: Callable, depth: int,
              device: torch.device) -> Iterator:
    """collect(dispatch(item, slot), slot) for each item, in order, with
    up to `depth` items in flight. dispatch runs on this thread under the
    slot's stream and is closed by the slot's event; collect runs on one
    of `depth` IO threads under the same stream. Item i takes slot
    i % depth, which item i - depth has left: its result was taken before
    item i is dispatched."""
    slots = [Slot(device) for _ in range(depth)]

    def run_collect(state, slot):
        with slot.use():
            return collect(state, slot)

    with cf.ThreadPoolExecutor(max_workers=depth, thread_name_prefix="ako-io") as io:
        futs: deque = deque()
        for i, item in enumerate(items):
            slot = slots[i % depth]
            with slot.use():
                state = dispatch(item, slot)
                slot.record()
            futs.append(io.submit(run_collect, state, slot))
            if len(futs) >= depth:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()


def _entropy_encode_image(streams: List[np.ndarray], grid, channels: int, s: Settings, head: bytes,
                          pool: Optional[cf.ThreadPoolExecutor]) -> bytes:
    """The host-entropy route's blocks of one image, coded on `pool`
    (ako_tpu/runtime/executor.py:44)."""

    def one(t, values):
        if s.compression == Compression.NONE:
            return values.tobytes()
        block = compress_block(values, tile_stream_bytes(t, s, channels), s.compression)
        if block is None:
            raise AkoError(Status.ERROR, "incompressible tile")
        return block

    if pool is None or len(grid) < 2:
        blocks = [one(t, v) for t, v in zip(grid, streams)]
    else:
        blocks = list(pool.map(one, grid, streams))
    return head + b"".join(blocks)


class PipelineEncoder:
    """Encode a stream of images with device/host overlap.

    >>> enc = PipelineEncoder(settings, workers=4)
    >>> for blob in enc.encode_iter(images):
    ...     sink(blob)
    """

    def __init__(self, settings: Optional[Settings] = None, workers: int = 4,
                 device_entropy: Optional[bool] = None, device=None):
        self.settings = checked_settings(settings)
        self.workers = max(1, workers)
        self.device_entropy = device_entropy
        self.device = resolve_device(device)

    def _device_entropy(self) -> bool:
        if self.device_entropy is not None:
            return self.device_entropy
        return self.device.type == "cuda"

    def encode_iter(self, images: Iterable[np.ndarray],
                    keep_residue: bool = False) -> Iterator[bytes]:
        """The blobs in the images' order. With `keep_residue`, (blob, None)
        pairs: ako_tpu's residue, the device-resident rows a paired decode
        reuses, is not ported."""
        if keep_residue:
            yield from ((blob, None) for blob in self.encode_iter(images))
            return
        s = self.settings
        if host_encode_mode():
            yield from self._encode_iter_host(images)
            return
        method = effective_method(s.compression)
        if self._device_entropy() and method in (Compression.KAGARI, Compression.MANBAVARAN):
            yield from _pipeline(images, self._dispatch_device_entropy,
                                 self._collect_device_entropy, _inflight(5), self.device)
            return
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            yield from _pipeline(images, self._dispatch_host_entropy,
                                 lambda state, slot: _entropy_encode_image(*state, pool), 2,
                                 self.device)

    def _dispatch_device_entropy(self, image, slot: Slot) -> tuple:
        s = self.settings
        image = checked_image(image)
        h, w, channels = image.shape
        head = container.head_write(channels, w, h, s)
        manba = effective_method(s.compression) == Compression.MANBAVARAN
        if manba:
            grid, dispatched = dispatch_tiles_manba(image, s, self.device, slot)
        else:
            grid, dispatched = dispatch_tiles_fused(image, s, self.device, host=slot)
        return head, manba, grid, dispatched

    def _collect_device_entropy(self, state: tuple, slot: Slot) -> bytes:
        head, manba, grid, dispatched = state
        if manba:
            blocks = collect_tiles_manba(grid, dispatched, self.settings, host=slot)
        else:
            blocks = collect_tiles_blocks(grid, dispatched, host=slot)
        return head + b"".join(blocks)

    def _dispatch_host_entropy(self, image, slot: Slot) -> tuple:
        """The device lift of one image and its streams' download, both
        waited for (the copies pageable, as encode's host-entropy route)."""
        s = self.settings
        image = checked_image(image)
        h, w, channels = image.shape
        head = container.head_write(channels, w, h, s)
        grid = geometry.tile_grid(w, h, s.tiles_dimension)
        return encode_tiles_device(image, s, self.device), grid, channels, s, head

    def _encode_iter_host(self, images: Iterable[np.ndarray]) -> Iterator[bytes]:
        """AKO_TPU_ENCODE=host (ako_tpu/runtime/executor.py:133): Kagari
        blobs through native span calls, each worker task one call over
        about 1/(2 workers) of an image's tiles (akort_tile_encode_spans
        cuts the rects, lifts, codes and frames the blocks itself); other
        methods per tile. Up to AKO_ENC_INFLIGHT images stay in flight so
        that the pool does not drain at image boundaries. No device work."""
        s = self.settings
        spans = effective_method(s.compression) == Compression.KAGARI
        depth = _inflight(3)
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending: deque = deque()

            def drain() -> bytes:
                head, futs, spanned = pending.popleft()
                if spanned is None:
                    return head + b"".join(blk for f in futs for blk in f.result())
                out, out_off, sizes = spanned
                for f in futs:
                    f.result()
                if not sizes.all():
                    raise AkoError(Status.ERROR, "incompressible tile")
                mv = memoryview(out)
                hs = BLOCK_HEAD.size
                return head + b"".join(mv[o : o + hs + n]
                                       for o, n in zip(out_off.tolist(), sizes.tolist()))

            for image in images:
                # the C side reads the image's rows through one pointer
                image = np.ascontiguousarray(checked_image(image))
                h, w, channels = image.shape
                head = container.head_write(channels, w, h, s)
                grid = geometry.tile_grid(w, h, s.tiles_dimension)
                # about two tasks a worker an image: few enough that submit
                # costs nothing, enough to even out the edge tiles
                k = max(1, -(-len(grid) // (2 * self.workers)))
                if spans:
                    plan = host_span_plan(w, h, channels, s.tiles_dimension, s.wavelet,
                                          s.quantization, s.gate, s.chroma_loss)
                    out = np.empty(plan.total_bytes, np.uint8)
                    sizes = np.zeros(len(grid), np.int64)
                    futs = [
                        pool.submit(hostcodec.tile_encode_spans, image, plan.rects[i : i + k],
                                    plan.qg_off[i : i + k], plan.qs, plan.gs,
                                    plan.counts[i : i + k], plan.caps[i : i + k], out,
                                    plan.out_off[i : i + k], sizes[i : i + k], s.wavelet, s.wrap,
                                    s.color, bool(s.discard_non_visible))
                        for i in range(0, len(grid), k)
                    ]
                    pending.append((head, futs, (out, plan.out_off, sizes)))
                else:
                    futs = [pool.submit(encode_tiles_host, image, s, tiles=grid[i : i + k])
                            for i in range(0, len(grid), k)]
                    pending.append((head, futs, None))
                if len(pending) >= depth:
                    yield drain()
            while pending:
                yield drain()

    def encode_batch(self, images: Iterable[np.ndarray]) -> List[bytes]:
        return list(self.encode_iter(images))


def _block_offsets(view, grid, s: Settings, channels: int) -> list:
    """(tile, offset of its block) in tile order: the sequential walk (a
    block's size is in its head)."""
    out, cursor = [], container.HEAD_SIZE
    for t in grid:
        out.append((t, cursor))
        _, cursor = read_tile_block(view, cursor, t, s, channels)
    return out


class PipelineDecoder:
    """Decode a stream of blobs with cross-image overlap: while image k's
    device work and pixel download run on its slot and its pixels are
    placed on the IO thread, image k+1's blocks are walked and scanned (or
    entropy-decoded) on the worker pool and its device work dispatched."""

    def __init__(self, workers: int = 4, device=None):
        self.workers = max(1, workers)
        self.device = resolve_device(device)

    def _entropy_stage(self, view, pool, grid, s: Settings, channels: int) -> list:
        """The host-entropy route: every tile's int16 stream, decoded on
        the pool after the walk."""

        def one(t, off):
            return read_tile_stream(view, off, t, s, channels)[0]

        return list(pool.map(one, *zip(*_block_offsets(view, grid, s, channels))))

    def _dispatch_device(self, streams, grid, channels: int, s: Settings, slot: Slot) -> list:
        """The host-entropy route's device stage: per shape group one upload
        of the streams, the unlift, one pixel download, enqueued."""
        dispatched = []
        for (tw, th), tiles in geometry.group_by_shape(grid).items():
            batch = torch.from_numpy(np.stack([streams[t.index] for t in tiles]))
            coeffs = to_device(batch, self.device, slot, ("streams", tw, th))
            dispatched.append((tiles, th, tw, stream_pixels(coeffs, tw, th, channels, s)))
        return dispatched

    def _collect(self, state: tuple, slot: Slot) -> np.ndarray:
        """One image's pixels: the host modes' futures joined, or the pixel
        downloads waited for and placed."""
        kind, parts, shape = state
        if kind == "hostspan":
            futs, image = parts
            for f in futs:  # the C side wrote the pixels in place
                f.result()
            return image
        image = np.empty(shape, dtype=np.uint8)
        if kind == "host":
            for f in parts:
                for t, pix in f.result():
                    image[t.y : t.y + t.h, t.x : t.x + t.w] = pix
            return image
        slot.wait()
        for tiles, th, tw, pix in parts:
            pix = pix.numpy()
            for i, t in enumerate(tiles):
                image[t.y : t.y + th, t.x : t.x + tw] = pix[i]
        return image

    def _dispatch_blob(self, blob: bytes, pool, device_entropy: bool, slot: Slot) -> tuple:
        """One blob -> (kind, parts, image shape) for _collect: the
        device-entropy decoder (only the sync scans on the host) where it
        applies, else the host entropy stage and the device unlift; on the
        device routes the pixels' downloads are enqueued too. With
        AKO_TPU_DECODE=host the blob stays on the host: its tiles decode
        on the worker pool, Kagari blobs through native span calls that
        write the pixels into the image."""
        view = memoryview(blob)
        channels, w, h, s = container.head_read(view)
        _check_decode_budget(w, h, channels)
        grid = geometry.tile_grid(w, h, s.tiles_dimension)
        shape = (h, w, channels)
        if host_decode_mode():
            return self._dispatch_host(blob, view, pool, grid, s, shape)
        if device_entropy and s.compression in (Compression.KAGARI, Compression.MANBAVARAN):
            dispatched = dispatch_tiles_device_entropy(view, container.HEAD_SIZE, grid, s, channels,
                                                       self.device, pool=pool, host=slot)
        else:
            streams = self._entropy_stage(view, pool, grid, s, channels)
            dispatched = self._dispatch_device(streams, grid, channels, s, slot)
        parts = [(tiles, th, tw, slot.download(("pixels", i), pixels))
                 for i, (tiles, th, tw, pixels) in enumerate(dispatched)]
        return "device", parts, shape

    def _dispatch_host(self, blob: bytes, view, pool, grid, s: Settings, shape: tuple) -> tuple:
        """AKO_TPU_DECODE=host (ako_tpu/runtime/executor.py:459-530): the
        tiles' decodes submitted to the pool, a span of tiles a task."""
        h, w, channels = shape
        n = len(grid)
        if s.compression == Compression.KAGARI:
            plan = host_decode_plan(w, h, channels, s.tiles_dimension, s.wavelet)
            pay_off = np.empty(n, np.int64)
            pay_size = np.empty(n, np.int64)
            cursor = container.HEAD_SIZE
            for i, t in enumerate(grid):
                payload, cursor = read_tile_block(view, cursor, t, s, channels)
                pay_size[i] = len(payload)
                pay_off[i] = cursor - len(payload)
            blob_arr = np.frombuffer(blob, dtype=np.uint8)
            image = np.empty((h, w, channels), dtype=np.uint8)
            k = max(1, -(-n // (2 * self.workers)))

            def span_call(lo: int, hi: int) -> None:
                if hostcodec.tile_decode_spans(blob_arr, pay_off[lo:hi], pay_size[lo:hi],
                                               plan.counts[lo:hi], plan.caps[lo:hi],
                                               plan.rects[lo:hi], image, s.wavelet, s.wrap,
                                               s.color):
                    raise AkoError(Status.BROKEN_INPUT)

            return "hostspan", ([pool.submit(span_call, lo, min(lo + k, n))
                                 for lo in range(0, n, k)], image), shape

        # MANBAVARAN payloads need the scan that tells rANS from Kagari,
        # NONE the raw copy: per tile
        def one(t, off):
            values, _ = read_tile_stream(view, off, t, s, channels)
            planes = hostcodec.tile_unlift(values, t.w, t.h, channels, s.wavelet, s.wrap)
            return t, hostcodec.planes_to_u8(planes, s.color)

        def span(items):  # submitting runs under the GIL: a few tiles a task
            return [one(t, off) for t, off in items]

        offsets = _block_offsets(view, grid, s, channels)
        k = max(1, n // (4 * self.workers))
        return "host", [pool.submit(span, offsets[i : i + k]) for i in range(0, n, k)], shape

    def decode_iter(self, blobs: Iterable, paired: bool = False,
                    device_entropy: Optional[bool] = None) -> Iterator[np.ndarray]:
        """The images in the blobs' order. With `paired`, items are (blob,
        residue) pairs from PipelineEncoder.encode_iter(keep_residue=True);
        the residue is not used. `device_entropy`: None means yes on the
        card and no on the CPU, as decode's."""
        if device_entropy is None:
            device_entropy = self.device.type == "cuda"
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:

            # two slots: image k+1 is dispatched while image k is collected
            yield from _pipeline(
                blobs,
                lambda item, slot: self._dispatch_blob(item[0] if paired else item, pool,
                                                       device_entropy, slot),
                self._collect, 2, self.device)


_STREAM_DONE = object()


def roundtrip_iter(images: Iterable[np.ndarray], settings: Optional[Settings] = None,
                   workers: int = 4, depth: int = 3, device_entropy: Optional[bool] = None,
                   device=None) -> Iterator[Tuple[bytes, np.ndarray]]:
    """Encode and decode as one overlapped stream, yielding (blob, pixels)
    for each image in order (ako_tpu/runtime/executor.py:568). The encoder
    runs on a thread of its own and feeds the decoder through a queue of
    `depth` blobs, which keeps the decoder fed across the encoder's
    jitter without growing without bound. An encoder error is raised in
    the stream's order; a consumer that stops early stops the encoder
    after the images in flight."""
    enc = PipelineEncoder(settings, workers=workers, device_entropy=device_entropy, device=device)
    dec = PipelineDecoder(workers=workers, device=device)
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def feed() -> Iterator[np.ndarray]:
        # on an early exit the encoder finishes the images in flight only
        for image in images:
            if stop.is_set():
                return
            yield image

    def produce() -> None:
        try:
            for blob in enc.encode_iter(feed()):
                q.put(blob)
                if stop.is_set():
                    return
            q.put(_STREAM_DONE)
        except BaseException as e:  # the consumer raises it in order
            q.put(e)
            if not isinstance(e, Exception):
                raise

    producer = threading.Thread(target=produce, name="ako-roundtrip-encoder", daemon=True)
    producer.start()
    # blobs taken by the decoder and not yet yielded (a few at most)
    blobs: deque = deque()

    def blob_stream() -> Iterator[bytes]:
        while True:
            item = q.get()
            if item is _STREAM_DONE:
                return
            if isinstance(item, BaseException):
                raise item
            blobs.append(item)
            yield item

    try:
        for pixels in dec.decode_iter(blob_stream(), device_entropy=device_entropy):
            yield blobs.popleft(), pixels
    finally:
        # a consumer that left early may have left the encoder blocked on
        # a full queue: signal it, and drain until it ends
        stop.set()
        while producer.is_alive():
            try:
                q.get_nowait()
            except queue.Empty:
                producer.join(timeout=0.1)

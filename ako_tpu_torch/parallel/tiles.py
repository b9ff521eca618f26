"""Tile-data-parallelism: the independent-tile grid sharded over a mesh
axis (the port of ako_tpu/parallel/tiles.py).

Ako tiles are fully independent (own pyramid, own quantization heads,
own entropy block), so each shape group's tiles are padded to a multiple
of the axis's size (`pad_batch`) and cut into equal runs, one a shard;
every shard runs the port's one-device functions on its run, on its own
stream: stage_tiles / forward_streams / K3 (kagari_encode_device) /
collect_tiles_blocks to encode, and pack_entropy_upload / K4
(kagari_decode_device) / stream_pixels to decode. The pad tiles' results
are dropped. Blobs and pixels are the one-device codec's.

Replaces the reference's sequential tile loop (library/encode.c:115,
library/decode.c:128) with one run per shard and shape group.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ako_tpu_torch.core import container, geometry
from ako_tpu_torch.core.settings import AkoError, Compression, Settings, Status
from ako_tpu_torch.decode import (
    _check_decode_budget,
    pack_entropy_upload,
    read_tile_block,
    read_tile_stream,
    split_entropy_upload,
    stream_pixels,
    tile_block_sizes,
)
from ako_tpu_torch.encode import (
    checked_settings,
    collect_tiles_blocks,
    forward_streams,
    pack_budget,
    stage_tiles,
    staging_source,
    tile_stream_bytes,
    with_fill,
)
from ako_tpu_torch.ops.kagari_device import (
    DECODE_BLOCK,
    decode_span_words,
    kagari_decode_device,
    kagari_encode_device,
)
from ako_tpu_torch.parallel.mesh import Mesh
from ako_tpu_torch.runtime.kagari import (
    BLOCK_HEAD,
    compress_block,
    effective_method,
    kagari_decode,
    kagari_sync,
)
from ako_tpu_torch.utils import metrics


def pad_batch(n: int, n_shards: int) -> int:
    """Tiles are padded to a multiple of the mesh size; the pad tiles
    are discarded after the gather."""
    return (n + n_shards - 1) // n_shards * n_shards


def _runs(n: int, n_shards: int) -> list:
    """Each shard's run [lo, hi) of a padded batch of n items."""
    per = pad_batch(n, n_shards) // n_shards
    return [(s * per, (s + 1) * per) for s in range(n_shards)]


def _shard_tiles(batch, lo: int, hi: int, shard, fill_val):
    """Tiles [lo, hi) of the host batch on the shard's device, zero tiles
    past its end, the constant last channel put back (with_fill)."""
    with shard.use():
        real = batch[lo:hi].to(shard.device)
        if real.shape[0] < hi - lo:
            real = torch.cat([real, real.new_zeros((hi - lo - real.shape[0],) + real.shape[1:])])
        return with_fill(real, fill_val)


def encode_tiles_sharded(
    image: np.ndarray,
    s: Settings,
    mesh: Mesh,
    axis_name: str = "tiles",
) -> list:
    """Device stage of encode over a mesh; returns per-tile int16
    streams in row-major tile order (same contract as
    encode.encode_tiles_device)."""
    image_h, image_w, channels = image.shape
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    shards = mesh.shards(axis_name)
    src, fill_val = staging_source(image)
    out: list = [None] * len(grid)
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        batch = stage_tiles(src, tiles, tw, th)
        done = []
        for shard, (lo, hi) in zip(shards, _runs(len(tiles), len(shards))):
            part = _shard_tiles(batch, lo, hi, shard, fill_val)
            with shard.use():
                done.append((shard, lo, forward_streams(part, tw, th, channels, s)))
        for shard, lo, streams in done:
            shard.synchronize()
            host = streams.cpu().numpy()
            for i, t in enumerate(tiles[lo : lo + len(host)]):
                out[t.index] = host[i]
    return out


def encode_image_sharded(
    image: np.ndarray,
    s: Settings,
    mesh: Mesh,
    axis_name: str = "tiles",
) -> bytes:
    """Full multi-device encode: tile grid sharded over the mesh, each
    shard's compressed rows gathered, container assembled on host.
    Byte-identical to the single-device encode()."""
    s = checked_settings(s)
    image_h, image_w, channels = image.shape
    head = container.head_write(channels, image_w, image_h, s)
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)

    # Raw blocks (NONE) and the real-rANS extension (MANBAVARAN under
    # AKO_TPU_MANBAVARAN=1) take the sharded lift with host framing,
    # matching the single-device encode()'s bytes for every method.
    if (
        s.compression == Compression.NONE
        or effective_method(s.compression) == Compression.MANBAVARAN
    ):
        parts: list = [head]
        for t, values in zip(grid, encode_tiles_sharded(image, s, mesh, axis_name)):
            if s.compression == Compression.NONE:
                parts.append(values.tobytes())
                continue
            block = compress_block(values, tile_stream_bytes(t, s, channels), s.compression)
            if block is None:
                raise AkoError(Status.ERROR, "incompressible tile")
            parts.append(block)
        return b"".join(parts)

    shards = mesh.shards(axis_name)
    src, fill_val = staging_source(image)
    dispatched = []
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        capacity = tile_stream_bytes(tiles[0], s, channels) - BLOCK_HEAD.size
        budget = pack_budget(capacity, s.quantization)
        batch = stage_tiles(src, tiles, tw, th)
        for shard, (lo, hi) in zip(shards, _runs(len(tiles), len(shards))):
            part = _shard_tiles(batch, lo, hi, shard, fill_val)
            with shard.use():
                # the stream stays on the shard for the near-capacity fallback
                stream = forward_streams(part, tw, th, channels, s)
                comp, totals = kagari_encode_device(stream, capacity, budget)
            real = tiles[lo:hi]
            if real:
                dispatched.append((shard, (real, stream, comp[: len(real)], totals[: len(real)],
                                           capacity, budget)))
    # Each shard's rows come back cut at its largest compressed size
    # (collect_tiles_blocks); ako_tpu rounds that width up to a power of
    # two (_bucket_width) only to bound its compiled gather programs,
    # which the port does not have. The blob is the same.
    blocks: list = [None] * len(grid)
    for shard, record in dispatched:
        shard.synchronize()
        got = collect_tiles_blocks(grid, [record])
        for t in record[0]:
            blocks[t.index] = got[t.index]
    return head + b"".join(blocks)


def decode_image_sharded(
    blob: bytes,
    mesh: Mesh,
    axis_name: str = "tiles",
    device_entropy: Optional[bool] = None,
):
    """Full multi-device decode, bit-identical to the single-device
    decode(); returns (image, settings, channels). With device entropy
    (None: when the axis's devices are CUDA), each shard decodes its own
    tiles with K4 from the host's sync scans, its own payloads packed
    into its own word pool; tiles with oversized codes (the
    zigzag(-32768) quirk) decode on the host exactly, then ride the
    sharded unlift with everyone else."""
    view = memoryview(blob)
    channels, image_w, image_h, s = container.head_read(view)
    _check_decode_budget(image_w, image_h, channels)
    cursor = container.HEAD_SIZE
    grid = geometry.tile_grid(image_w, image_h, s.tiles_dimension)
    if device_entropy is None:
        device_entropy = all(d.type == "cuda" for d in mesh.axis_devices(axis_name))

    image = np.empty((image_h, image_w, channels), dtype=np.uint8)

    if not (device_entropy and s.compression == Compression.KAGARI):
        streams = []
        for t in grid:
            values, cursor = read_tile_stream(view, cursor, t, s, channels)
            streams.append(values)
        decode_tiles_sharded(streams, grid, image, s, channels, mesh, axis_name)
        return image, s, channels

    per_shape: dict = {}
    host_streams: dict = {}
    for t in grid:
        payload, cursor = read_tile_block(view, cursor, t, s, channels)
        tds, spacing = tile_block_sizes(t, s, channels)
        sync = kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK)
        if sync is None or sync[4] != len(payload):
            raise AkoError(Status.BROKEN_INPUT)
        if sync[5] > 31:
            res = kagari_decode(tds // 2, payload, tds + spacing)
            if res is None:
                raise AkoError(Status.BROKEN_INPUT)
            host_streams[t.index] = res[0]
        else:
            per_shape.setdefault((t.w, t.h), []).append((t, payload, sync))
    metrics.bump(metrics.DEC_DEVICE, sum(map(len, per_shape.values())))
    metrics.bump(metrics.DEC_HOST_FALLBACK, len(host_streams))

    shards = mesh.shards(axis_name)
    done = []
    for (tw, th), items in per_shape.items():
        count = geometry.tile_data_size(tw, th) * channels // 2
        # pad rows repeat the last real tile: a valid decode whose output
        # is dropped (zero rows would make the decoder chase garbage
        # offsets)
        padded = items + [items[-1]] * (pad_batch(len(items), len(shards)) - len(items))
        for shard, (lo, hi) in zip(shards, _runs(len(items), len(shards))):
            run = padded[lo:hi]
            span = None  # K4 reads the pool; only the plain decoder needs a window
            if shard.device.type == "cpu":
                span = max(decode_span_words(sy[0], len(p) * 8) for _, p, sy in run)
            buf, T, B = pack_entropy_upload(run)
            with shard.use():
                parts = split_entropy_upload(torch.from_numpy(buf).to(shard.device), T, B)
                coeffs = kagari_decode_device(*parts, count, DECODE_BLOCK, span)
                done.append((shard, [t for t, _, _ in items[lo:hi]],
                             stream_pixels(coeffs, tw, th, channels, s)))
    _place(done, image)

    if host_streams:
        host_grid = [t for t in grid if t.index in host_streams]
        # reindex into a dense list for decode_tiles_sharded's contract
        dense = [host_streams[t.index] for t in host_grid]
        remapped = [
            geometry.TilePlacement(i, t.x, t.y, t.w, t.h)
            for i, t in enumerate(host_grid)
        ]
        decode_tiles_sharded(dense, remapped, image, s, channels, mesh, axis_name)

    return image, s, channels


def _place(done: list, image: np.ndarray) -> None:
    """Each shard's (T, th, tw, C) pixels into `image` at its tiles, once
    its stream is done; its pad tiles' pixels are dropped."""
    for shard, tiles, pixels in done:
        shard.synchronize()
        pix = pixels.cpu().numpy()
        for i, t in enumerate(tiles):
            image[t.y : t.y + t.h, t.x : t.x + t.w, :] = pix[i]


def decode_tiles_sharded(
    streams: list,
    grid: list,
    image: np.ndarray,
    s: Settings,
    channels: int,
    mesh: Mesh,
    axis_name: str = "tiles",
) -> None:
    """Device stage of decode over a mesh; writes pixels into `image`
    in place (same contract as the loop in decode.decode)."""
    shards = mesh.shards(axis_name)
    done = []
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        batch = torch.from_numpy(np.stack([streams[t.index] for t in tiles], axis=0))
        for shard, (lo, hi) in zip(shards, _runs(len(tiles), len(shards))):
            with shard.use():
                coeffs = batch[lo:hi].to(shard.device)
                if coeffs.shape[0] < hi - lo:
                    coeffs = torch.cat([coeffs, coeffs.new_zeros(
                        (hi - lo - coeffs.shape[0], coeffs.shape[1]))])
                done.append((shard, tiles[lo:hi], stream_pixels(coeffs, tw, th, channels, s)))
    _place(done, image)

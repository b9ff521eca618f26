"""Tile-data-parallelism: the independent-tile grid sharded over a mesh
axis (the port of ako_tpu/parallel/tiles.py).

Ako tiles are fully independent (own pyramid, own quantization heads,
own entropy block), so each shape group's tiles are padded to a multiple
of the axis's size (`pad_batch`) and cut into equal runs, one a shard;
each shard runs the one-device group functions on its run, on its own
stream (parallel/mesh.py Shard, a lane whose copies are plain):
encode.stage_group / encode.dispatch_group (the lift and K3) /
encode.collect_tiles_blocks to encode, and decode.dispatch_entropy (K4
and the unlift) or decode.dispatch_streams / decode.place to decode. The
pad tiles' results are dropped. Blobs and pixels are the one-device codec's.

Each shard's work stays on its device and stream, whether the mesh's
devices are distinct cards or one card repeated. The route's host work
is spans (utils/tracing.py): `ako.shard.encode` and `ako.shard.decode`
around each call; in the Kagari encode `ako.shard.encode.stage` (the
staging, a shape group), `ako.shard.encode.dispatch` (a shard's upload
and launches, a shard and group) and `ako.shard.encode.collect` (a
shard's wait and framing, a shard and group with real tiles); in the
device-entropy decode `ako.shard.decode.scan` (the block walk and the
sync scans: the one-device decode's `decode.scan_blocks`, one native
call on `os.cpu_count()` threads), `ako.shard.decode.dispatch` (a
shard's packing, upload and launches, a shard and group) and
`ako.shard.decode.place` (a shard's wait, download and placement, a
shard and group). The counters `shard_tiles` and `shard_pad_tiles`
(utils/metrics.py) count the real and the pad tiles dispatched.

Replaces the reference's sequential tile loop (library/encode.c:115,
library/decode.c:128) with one run per shard and shape group.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ako_tpu_torch.core import container, geometry
from ako_tpu_torch.core.settings import Compression, Settings
from ako_tpu_torch.decode import (
    _check_decode_budget,
    dispatch_entropy,
    dispatch_streams,
    place,
    quirk_streams,
    read_tile_stream,
    scan_blocks,
)
from ako_tpu_torch.encode import (
    checked_settings,
    collect_tiles_blocks,
    dispatch_group,
    host_block,
    stage_group,
    stage_tiles,
    tile_stream_bytes,
)
from ako_tpu_torch.parallel.mesh import Mesh
from ako_tpu_torch.runtime.kagari import effective_method
from ako_tpu_torch.utils import metrics, tracing


def pad_batch(n: int, n_shards: int) -> int:
    """Tiles are padded to a multiple of the mesh size; the pad tiles
    are discarded after the gather."""
    return (n + n_shards - 1) // n_shards * n_shards


def _runs(n: int, n_shards: int) -> list:
    """Each shard's run [lo, hi) of a padded batch of n items, counted as
    n real tiles and the pad's tiles dispatched (every caller dispatches
    each run)."""
    padded = pad_batch(n, n_shards)
    metrics.bump(metrics.SHARD_TILES, n)
    metrics.bump(metrics.SHARD_PAD_TILES, padded - n)
    per = padded // n_shards
    return [(s * per, (s + 1) * per) for s in range(n_shards)]


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
    src, fill_val = shards[0].source(image)
    out: list = [None] * len(grid)
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        batch = stage_tiles(src, tiles, tw, th)
        done = []
        for shard, run in zip(shards, _runs(len(tiles), len(shards))):
            with shard.use():
                part = stage_group(shard, batch, fill_val, run)
                done.append((shard, dispatch_group(shard, tiles, part, channels, s, run,
                                                   entropy=False)))
        for shard, (real, streams) in done:
            with shard.use():
                for t, values in zip(real, shard.fetch(("streams", tw, th), streams)):
                    out[t.index] = values
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
    with tracing.span("ako.shard.encode"):
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
            streams = encode_tiles_sharded(image, s, mesh, axis_name)
            return head + b"".join(host_block(v, tile_stream_bytes(t, s, channels), s.compression)
                                   for t, v in zip(grid, streams))

        shards = mesh.shards(axis_name)
        src = fill_val = None
        dispatched = []
        for (tw, th), tiles in geometry.group_by_shape(grid).items():
            with tracing.span("ako.shard.encode.stage"):
                if src is None:  # in the first group's span: one span a group
                    src, fill_val = shards[0].source(image)
                batch = stage_tiles(src, tiles, tw, th)
            for shard, run in zip(shards, _runs(len(tiles), len(shards))):
                with tracing.span("ako.shard.encode.dispatch"), shard.use():
                    part = stage_group(shard, batch, fill_val, run)
                    record = dispatch_group(shard, tiles, part, channels, s, run)
                if record[0]:
                    dispatched.append((shard, record))
        # Each shard's rows come back cut at its largest compressed size
        # (collect_tiles_blocks); ako_tpu rounds that width up to a power of
        # two (_bucket_width) only to bound its compiled gather programs,
        # which the port does not have. The blob is the same.
        blocks: list = [None] * len(grid)
        for shard, record in dispatched:
            with tracing.span("ako.shard.encode.collect"), shard.use():
                got = collect_tiles_blocks(grid, [record], shard)
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
    with tracing.span("ako.shard.decode"):
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

        host_streams: dict = {}
        with tracing.span("ako.shard.decode.scan"):
            per_shape, _, quirks = scan_blocks(view, cursor, grid, s, channels)
            for items in quirks.values():
                for (t, _, _), values in zip(items, quirk_streams(items, s, channels)):
                    host_streams[t.index] = values

        shards = mesh.shards(axis_name)
        done = []
        for items in per_shape.values():
            tiles = [t for t, _, _ in items]
            for shard, run in zip(shards, _runs(len(items), len(shards))):
                with tracing.span("ako.shard.decode.dispatch"), shard.use():
                    done.append((shard, tiles[run[0] : run[1]],
                                 dispatch_entropy(shard, items, channels, s, run=run)))
        _place_runs(done, image)

        if host_streams:
            host_grid = [t for t in grid if t.index in host_streams]
            decode_tiles_sharded(host_streams, host_grid, image, s, channels, mesh, axis_name)

        return image, s, channels


def _place_runs(done: list, image: np.ndarray) -> None:
    """Each shard's run of pixels into `image` at its tiles, once its
    stream is done (decode.place). One span ako.shard.decode.place a
    shard's run."""
    for shard, tiles, pixels in done:
        with tracing.span("ako.shard.decode.place"), shard.use():
            place(image, tiles, shard.fetch(("pixels",), pixels))


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
    in place (same contract as the loop in decode.decode). `streams` maps
    each tile's index to its int16 stream (a list in grid order, or a
    dict for a part of the grid)."""
    shards = mesh.shards(axis_name)
    done = []
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        batch = np.stack([streams[t.index] for t in tiles])
        for shard, run in zip(shards, _runs(len(tiles), len(shards))):
            with shard.use():
                done.append((shard, tiles[run[0] : run[1]], dispatch_streams(
                    shard, batch, tw, th, channels, s, ("streams", tw, th), run)))
    _place_runs(done, image)

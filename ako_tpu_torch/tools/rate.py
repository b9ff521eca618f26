"""Rate control: search quantization to hit a target compression ratio.

The counterpart of ako_tpu/tools/rate.py, with the same search as the
reference's EncodePass (tools/akoenc.cpp:112-216): target = (w*h*ch)/ratio
bytes with a 4% error margin; one q=0 ceiling pass, an exponential x4
descent to find a floor, then bisection while the bracket is wider than
the margin and |floor_q - ceil_q| > 1; finally whichever endpoint lands
closer.

As in ako_tpu, the wavelet pyramid is computed once per colour variant
and each probe re-runs only the quantize/gate and the Kagari sizing
(ops/rate_device.py). The cached pyramid is each shape group's raw
stream, lifted once at an identity q/g table (one lift_pyramid launch,
after lift_level launches on large planes); a probe is then one K8p
launch per shape group, and one int64 a tile comes back. Probe sizes are
exact, and the chosen q gives a blob byte-identical to a direct encode at
that q: encode_at serializes the cached pyramid (K8s) and packs it with
K3, framed by encode.collect_tiles_blocks, with the same budget and host
fallback as encode's device-entropy path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ako_tpu_torch.core import container, geometry
from ako_tpu_torch.core.settings import AkoError, Color, Compression, Settings, Status, Wavelet
from ako_tpu_torch.encode import (
    _CAPACITY_MARGIN,
    checked_settings,
    collect_tiles_blocks,
    pack_budget,
    resolve_device,
    stage_tiles,
    staging_source,
    tile_qg,
    with_fill,
)
from ako_tpu_torch.ops.kagari_device import kagari_encode_device
from ako_tpu_torch.ops.lifting import forward_tiles
from ako_tpu_torch.ops.rate_device import identity_qg, probe_qg, rate_serialize, rate_sizes
from ako_tpu_torch.runtime.kagari import BLOCK_HEAD, compress_block, effective_method


class _CachedEncoder:
    """Encodes the same image at many quantization factors, computing
    the wavelet pyramid at most once per color variant, on `device`
    (None: the CUDA card, which must be there; "cpu": the plain torch
    path)."""

    def __init__(self, image: np.ndarray, base: Settings, device=None):
        self.image = image
        self.base = base
        self.h, self.w, self.channels = image.shape
        self.device = resolve_device(device)
        self._pyramids: Dict[Color, list] = {}
        self._source = None

    def _settings_at(self, q: int) -> Settings:
        # The reference's EncodePass keeps the user's gate for EVERY
        # probe, including the q=0 ceiling pass (akoenc.cpp:139-143) —
        # only the ratio==1 path zeroes it. The gate also feeds the
        # YCoCg->YCoCg_Q auto-switch, so zeroing it here would change
        # both probe sizes and, at chosen q==0, the final blob.
        return checked_settings(self.base.replace(quantization=q))

    def _tile_pyramids(self, s: Settings) -> list:
        """Per shape group (tiles, raw (T, n) int16 streams on the
        device): the colour transform and the lift at the identity q/g
        table, staged as encode.dispatch_tiles_fused stages them, once per
        colour variant."""
        key = s.color
        if key in self._pyramids:
            return self._pyramids[key]
        if self._source is None:
            self._source = staging_source(self.image)
        src, fill_val = self._source
        grid = geometry.tile_grid(self.w, self.h, s.tiles_dimension)
        out = []
        for (tw, th), tiles in geometry.group_by_shape(grid).items():
            schedule = geometry.lift_schedule(tw, th)
            tiles_dev = with_fill(stage_tiles(src, tiles, tw, th).to(self.device), fill_val)
            raw = forward_tiles(tiles_dev, schedule, s.wavelet, s.wrap,
                                identity_qg(schedule, self.channels), s.color,
                                bool(s.discard_non_visible))
            out.append((tiles, raw))
        self._pyramids[key] = out
        return out

    def _probe(self, tiles, s: Settings) -> tuple:
        """(schedule, qs, gs, tile data size) of a shape group at s."""
        tw, th = tiles[0].w, tiles[0].h
        qg = tile_qg(tw, th, self.channels, s.quantization, s.gate, s.chroma_loss)
        qs, gs = probe_qg(qg, self.channels)
        return (geometry.lift_schedule(tw, th), qs, gs,
                geometry.tile_data_size(tw, th) * self.channels)

    def encode_at(self, q: int) -> Optional[bytes]:
        """Full blob at quantization q (None if an incompressible tile
        fails, like the reference's error path). On the card the entropy
        stage is K3 with the same budget/fallback split and row download
        as the encoder's device-entropy path (encode.collect_tiles_blocks);
        on the CPU, and for MANBAVARAN under the rANS extension, the host
        coder codes each tile."""
        s = self._settings_at(q)
        head = container.head_write(self.channels, self.w, self.h, s)
        grid = geometry.tile_grid(self.w, self.h, s.tiles_dimension)
        # the device packer emits Kagari blocks; the real-rANS
        # extension (effective MANBAVARAN) must host-code
        device_entropy = (self.device.type == "cuda"
                          and effective_method(s.compression) != Compression.MANBAVARAN)
        blocks: list = [None] * len(grid)
        dispatched = []
        for tiles, raw in self._tile_pyramids(s):
            schedule, qs, gs, tds = self._probe(tiles, s)
            streams = rate_serialize(raw, schedule, self.channels, qs, gs)
            if device_entropy:
                capacity = tds - BLOCK_HEAD.size
                budget = pack_budget(capacity, s.quantization)
                comp, totals = kagari_encode_device(streams, capacity, budget)
                dispatched.append((tiles, streams, comp, totals, capacity, budget))
                continue
            host = streams.cpu().numpy()
            for i, t in enumerate(tiles):
                block = compress_block(host[i], tds, s.compression)
                if block is None:
                    return None
                blocks[t.index] = block
        if dispatched:
            try:
                for t, block in zip(grid, collect_tiles_blocks(grid, dispatched)):
                    if block is not None:
                        blocks[t.index] = block
            except AkoError:
                return None
        return head + b"".join(blocks)

    def size_at(self, q: int) -> int:
        """Exact blob size at quantization q WITHOUT materializing the
        blob: one K8p launch per shape group maps and tokenizes the cached
        pyramid and returns one int64 per tile. Tiles inside the host
        coder's near-capacity margin are serialized (K8s) and re-coded on
        the host so the reference's exact bounds checks decide success,
        mirroring encode.collect_tiles_blocks."""
        s = self._settings_at(q)
        if effective_method(s.compression) == Compression.MANBAVARAN:
            # rANS payload sizes are not the tokenizer's Kagari sizes:
            # size the real blob (still cached-pyramid cheap)
            blob = self.encode_at(q)
            if blob is None:
                raise AkoError(Status.ERROR, "incompressible tile")
            self._last = q
            return len(blob)
        total = container.HEAD_SIZE
        for tiles, raw in self._tile_pyramids(s):
            schedule, qs, gs, tds = self._probe(tiles, s)
            sizes = rate_sizes(raw, schedule, self.channels, qs, gs).cpu().numpy()
            capacity = tds - BLOCK_HEAD.size
            risky = np.flatnonzero(sizes >= capacity - _CAPACITY_MARGIN)
            if len(risky):
                index = torch.from_numpy(risky).to(raw.device)
                streams = rate_serialize(raw[index], schedule, self.channels, qs, gs)
                for values, i in zip(streams.cpu().numpy(), risky):
                    block = compress_block(values, tds, s.compression)
                    if block is None:
                        raise AkoError(Status.ERROR, "incompressible tile")
                    sizes[i] = len(block) - BLOCK_HEAD.size
            total += int(sizes.sum()) + BLOCK_HEAD.size * len(tiles)
        self._last = q
        return total


def encode_with_ratio(
    image: np.ndarray,
    settings: Settings,
    ratio: int,
    verbose: bool = False,
    device=None,
) -> Tuple[bytes, int]:
    """Returns (blob, chosen_quantization). Search identical to the
    reference's EncodePass; probes reuse the cached pyramid. `device` as
    encode's: None is the CUDA card (raises when there is none), "cpu"
    the plain torch path."""
    from ako_tpu_torch.encode import encode

    s = checked_settings(settings)
    if ratio == 0 or s.wavelet == Wavelet.NONE or s.compression == Compression.NONE:
        return encode(image, s, device=device), s.quantization
    if ratio == 1:
        s0 = s.replace(quantization=0, gate=0)
        return encode(image, s0, device=device), 0

    h, w, ch = image.shape
    target_size = (w * h * ch) // ratio
    error_margin = (target_size * 4) // 100
    if verbose:
        print(f"Target: {target_size / 1000:.2f} kB, error: {error_margin / 1000:.2f} kB...")

    enc = _CachedEncoder(image, settings, device)

    ceil_size = enc.size_at(0)
    q = 1
    floor_size, floor_q, ceil_q = ceil_size, 0, 0
    while True:
        q *= 4
        ceil_size, ceil_q = floor_size, floor_q
        floor_size, floor_q = enc.size_at(q), q
        if verbose:
            print(f" - Q: {ceil_q}|{floor_q}, {ceil_size/1000:.1f}|{floor_size/1000:.1f} kB")
        if floor_size <= target_size:
            break

    last_size = floor_size
    while (
        max(floor_size, ceil_size) - min(floor_size, ceil_size) > error_margin
        and abs(floor_q - ceil_q) > 1
    ):
        q = (ceil_q + floor_q) // 2
        last_size = enc.size_at(q)
        if last_size > target_size:
            ceil_size, ceil_q = last_size, q
        else:
            floor_size, floor_q = last_size, q
        if verbose:
            print(f" - Q: {ceil_q}|{floor_q}, {ceil_size/1000:.1f}|{floor_size/1000:.1f} kB")

    if (max(floor_size, target_size) - min(floor_size, target_size)) < (
        max(ceil_size, target_size) - min(ceil_size, target_size)
    ):
        chosen, chosen_size = floor_q, floor_size
    else:
        chosen, chosen_size = ceil_q, ceil_size
    if verbose:
        print(f" - Q: {chosen}")

    # Reference reuse quirk (akoenc.cpp:193-212): the LAST probe's blob
    # is emitted whenever its size numerically equals the chosen
    # endpoint's size — even on a size plateau where that probe ran at
    # a DIFFERENT q than `chosen`. Probes do not materialize blobs, so
    # re-encode at the last probe's q — the codec is deterministic, so
    # the bytes equal the blob the reference would have reused.
    last_q = getattr(enc, "_last", None)
    emit_q = last_q if (last_q is not None and last_size == chosen_size) else chosen
    blob = enc.encode_at(emit_q)
    if blob is None:
        raise AkoError(Status.ERROR, "incompressible tile")
    return blob, chosen

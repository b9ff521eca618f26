"""Whole-tile dyadic lift/unlift pipelines, batched over tiles.

The reference's per-tile / per-level / per-channel scalar recursion
(library/lifting.c:171-304) becomes, per tile-shape group:

- `forward_tiles` / `inverse_tiles`, the codec's route from u8 tiles to
  the serialized coefficient streams and back. In the fused wiring
  (AKO_TORCH_LIFT_MODE, default) every level from `pyramid_start` on is
  one lift_pyramid / unlift_pyramid launch, and each level before it
  (planes too large for a pyramid block; every level when pyramid_start
  is None) one lift_level / unlift_level launch; the colour transform,
  quantize/gate, wire order and the dequantize are fused into whichever
  kernel takes level 0 and each level (ops/lift_kernels.py), so no torch
  op runs between the staged tiles and the streams, nor between the
  streams and the pixels. In the split wiring every level runs through
  the V-only kernels.
- `forward_tile` / `inverse_tile`, every level per level, on planes
  after the colour transform: the split wiring's route (and a tile with
  no lift level), and the counterpart of ako_tpu/ops/lifting.py.

Quantization + noise gate apply to the highpass quadrants
(library/lifting.c:154-168), and the stream is in exact wire order
(library/misc.c:229-288): LP planes per channel, then per level
small->large, per channel: [int16 q head][HP-C][HP-B][HP-D]. Same stream
as ako_tpu/ops/lifting.py.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ako_tpu_torch.core.geometry import LiftSchedule
from ako_tpu_torch.core.settings import Color, Wavelet, Wrap
from ako_tpu_torch.ops.colorspace import to_interleaved_u8, to_planar_yuv
from ako_tpu_torch.ops.lift_kernels import (
    forward_levels,
    forward_pyramid,
    inverse_levels,
    inverse_pyramid,
    lift2d_level,
    lift_levels,
    lift_mode,
    load_lp,
    lp_view,
    pyramid_start,
    store_lp,
    unlift2d_level,
    unlift_levels,
)

QG = Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]]


def forward_tile(planes, schedule: LiftSchedule, wavelet: Wavelet, wrap: Wrap, qg: QG):
    """planes: (..., channels, tile_h, tile_w) int16, contiguous ->
    serialized coefficient stream (..., coeff_count) int16, one
    lift2d_level call per level."""
    batch, channels = planes.shape[:-3], planes.shape[-3]
    flat = planes.reshape((-1,) + tuple(planes.shape[-3:]))
    stream = flat.new_empty((flat.shape[0], schedule.coeff_count(channels)))
    ll = lift_levels(flat, stream, schedule, range(len(schedule.levels)), wavelet, wrap, qg,
                     lift2d_level)
    store_lp(stream, ll)
    return stream.reshape(batch + (-1,))


def inverse_tile(coeffs, schedule: LiftSchedule, wavelet: Wavelet, wrap: Wrap, channels: int):
    """Serialized stream (..., coeff_count) int16 -> planes
    (..., channels, tile_h, tile_w) int16, one unlift2d_level call per
    level.

    Quantization heads are runtime data from the stream; inverse
    quantization is the int16-wrapping multiply of
    library/lifting.c:30-40, skipped for q <= 1."""
    batch = coeffs.shape[:-1]
    flat = coeffs.reshape(-1, coeffs.shape[-1])
    planes = unlift_levels(load_lp(flat, schedule, channels), flat, schedule,
                           range(len(schedule.levels)), wavelet, wrap, unlift2d_level)
    return planes.reshape(batch + tuple(planes.shape[1:]))


def forward_tiles(tiles_u8, schedule: LiftSchedule, wavelet: Wavelet, wrap: Wrap, qg: QG,
                  color: Color, discard: bool):
    """(T, tile_h, tile_w, C) u8 tiles -> (T, coeff_count) int16 streams:
    colour transform, lift, quantize/gate. In the fused wiring, levels
    [0, pyramid_start) run one forward_levels launch each, from the u8
    tiles, and the rest one forward_pyramid launch (every level through
    forward_levels when pyramid_start is None). In the split wiring, and
    for a tile with no level, a torch colour transform and forward_tile."""
    channels = tiles_u8.shape[-1]
    levels = len(schedule.levels)
    if lift_mode() == "split" or not levels:
        planes = to_planar_yuv(tiles_u8, color, discard).contiguous()
        return forward_tile(planes, schedule, wavelet, wrap, qg)
    start = pyramid_start(schedule, channels)
    stream = torch.empty((tiles_u8.shape[0], schedule.coeff_count(channels)),
                         dtype=torch.int16, device=tiles_u8.device)
    x = tiles_u8.contiguous()
    if start != 0:
        x = forward_levels(x, stream, schedule, range(levels if start is None else start),
                           wavelet, wrap, qg, color, discard)
    if start is not None:
        forward_pyramid(x, stream, schedule, start, wavelet, wrap, qg, color, discard)
    return stream


def inverse_tiles(coeffs, schedule: LiftSchedule, wavelet: Wavelet, wrap: Wrap, channels: int,
                  color: Color):
    """(T, coeff_count) int16 streams -> (T, tile_h, tile_w, C) u8 tiles:
    dequantize, unlift, inverse colour transform. In the fused wiring,
    the levels from pyramid_start are one inverse_pyramid launch and the
    levels before it one inverse_levels launch each, the last with the
    inverse colour transform (every level through inverse_levels, from
    the streams' LP head, when pyramid_start is None). In the split
    wiring, and for a tile with no level, inverse_tile and a torch
    colour transform."""
    levels = len(schedule.levels)
    coeffs = coeffs.contiguous()
    if lift_mode() == "split" or not levels:
        planes = inverse_tile(coeffs, schedule, wavelet, wrap, channels)
        return to_interleaved_u8(planes, color, channels).contiguous()
    start = pyramid_start(schedule, channels)
    if start == 0:
        return inverse_pyramid(coeffs, schedule, 0, wavelet, wrap, channels, color)
    if start is None:
        ll, start = lp_view(coeffs, schedule, channels), levels
    else:
        ll = inverse_pyramid(coeffs, schedule, start, wavelet, wrap, channels, color)
    return inverse_levels(ll, coeffs, schedule, range(start), wavelet, wrap, channels, color)

"""Whole-tile dyadic lift/unlift pipelines, batched over tiles.

The reference's per-tile / per-level / per-channel scalar recursion
(library/lifting.c:171-304) becomes, per tile-shape group:

- `forward_tiles` / `inverse_tiles`, the codec's route from u8 tiles to
  the serialized coefficient streams and back. In the fused wiring
  (AKO_TORCH_LIFT_MODE, default) every level from `pyramid_start` on is
  one lift_pyramid / unlift_pyramid launch with the colour transform,
  quantize/gate and wire order fused (ops/lift_kernels.py); the levels
  before it (planes too large for a block's shared memory) run one
  kernel call each. In the split wiring every level runs through the
  V-only kernels.
- `forward_tile` / `inverse_tile`, every level per level, on planes
  after the colour transform: the split wiring's route, and the
  counterpart of ako_tpu/ops/lifting.py.

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
    forward_pyramid,
    inverse_pyramid,
    lift2d_level,
    lift_levels,
    lift_mode,
    load_lp,
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
    [0, pyramid_start) run per level after a torch colour transform and
    the rest in one forward_pyramid launch (every level per level when
    pyramid_start is None, and in the split wiring)."""
    channels = tiles_u8.shape[-1]
    start = pyramid_start(schedule, channels) if lift_mode() == "fused" else None
    if start != 0:
        planes = to_planar_yuv(tiles_u8, color, discard).contiguous()
        if start is None:
            return forward_tile(planes, schedule, wavelet, wrap, qg)
    stream = torch.empty((tiles_u8.shape[0], schedule.coeff_count(channels)),
                         dtype=torch.int16, device=tiles_u8.device)
    if start == 0:
        forward_pyramid(tiles_u8.contiguous(), stream, schedule, 0, wavelet, wrap, qg, color,
                        discard)
    else:
        ll = lift_levels(planes, stream, schedule, range(start), wavelet, wrap, qg, lift2d_level)
        forward_pyramid(ll, stream, schedule, start, wavelet, wrap, qg, color, discard)
    return stream


def inverse_tiles(coeffs, schedule: LiftSchedule, wavelet: Wavelet, wrap: Wrap, channels: int,
                  color: Color):
    """(T, coeff_count) int16 streams -> (T, tile_h, tile_w, C) u8 tiles:
    dequantize, unlift, inverse colour transform. In the fused wiring,
    the levels from pyramid_start are one inverse_pyramid launch, the
    levels before it run per level and the colour transform in torch."""
    start = pyramid_start(schedule, channels) if lift_mode() == "fused" else None
    coeffs = coeffs.contiguous()
    if start is None:
        planes = inverse_tile(coeffs, schedule, wavelet, wrap, channels)
    else:
        out = inverse_pyramid(coeffs, schedule, start, wavelet, wrap, channels, color)
        if start == 0:
            return out
        planes = unlift_levels(out, coeffs, schedule, range(start), wavelet, wrap, unlift2d_level)
    return to_interleaved_u8(planes, color, channels).contiguous()

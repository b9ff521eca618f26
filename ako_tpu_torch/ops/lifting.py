"""Whole-tile dyadic lift/unlift pipelines, batched over tiles.

The reference's per-tile / per-level / per-channel scalar recursion
(library/lifting.c:171-304) becomes a Python loop over the level
schedule, with every level processing all channels of all same-shaped
tiles at once through one kernel call (ops/lift_kernels.py).
Quantization + noise gate apply to the highpass quadrants
(library/lifting.c:154-168), and the output is the serialized
coefficient stream in exact wire order (library/misc.c:229-288): LP
planes per channel, then per level small->large, per channel:
[int16 q head][HP-C][HP-B][HP-D]. Same stream as
ako_tpu/ops/lifting.py.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ako_tpu_torch.core.geometry import LiftSchedule
from ako_tpu_torch.core.settings import Wavelet, Wrap
from ako_tpu_torch.ops.intmath import divt, i16, i32
from ako_tpu_torch.ops.lift_kernels import lift2d_level, unlift2d_level
from ako_tpu_torch.ops.wavelets import effective_wavelet


def _quantize_gate(x, q, g):
    """Dead-zone gate + truncating quantization on an int16 quadrant;
    q/g broadcastable int32 (library/lifting.c:154-168)."""
    x32 = i32(x)
    keep = (x32 < -g) | (x32 > g)
    return i16(torch.where(keep, divt(x32, q.clamp(min=1)), 0))


def forward_tile(
    planes,
    schedule: LiftSchedule,
    wavelet: Wavelet,
    wrap: Wrap,
    qg: Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]],
):
    """planes: (..., channels, tile_h, tile_w) int16, contiguous ->
    serialized coefficient stream (..., coeff_count) int16."""
    channels = planes.shape[-3]
    batch = planes.shape[:-3]
    dev = planes.device

    level_chunks = []
    cur = planes
    for lvl, (qs, gs) in zip(schedule.levels, qg):
        weff = effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        ll, b, c, d = lift2d_level(weff, wrap, cur, lvl)

        q = torch.tensor(qs, dtype=torch.int32, device=dev).reshape(channels, 1, 1)
        g = torch.tensor(gs, dtype=torch.int32, device=dev).reshape(channels, 1, 1)
        quads = [_quantize_gate(t, q, g).reshape(batch + (channels, -1)) for t in (c, b, d)]
        head = i16(torch.tensor(qs, dtype=torch.int32, device=dev))
        head = head.reshape(channels, 1).expand(batch + (channels, 1))
        chunk = torch.cat([head, *quads], dim=-1)
        level_chunks.append(chunk.reshape(batch + (-1,)))
        cur = ll

    lp_flat = cur.reshape(batch + (-1,))
    # wire order: LP planes first, then levels smallest -> largest
    return torch.cat([lp_flat] + level_chunks[::-1], dim=-1)


def inverse_tile(
    coeffs,
    schedule: LiftSchedule,
    wavelet: Wavelet,
    wrap: Wrap,
    channels: int,
):
    """Serialized stream (..., coeff_count) int16 -> planes
    (..., channels, tile_h, tile_w) int16.

    Quantization heads are runtime data from the stream; inverse
    quantization is the int16-wrapping multiply of
    library/lifting.c:30-40, skipped for q <= 1."""
    batch = coeffs.shape[:-1]
    lp_n = channels * schedule.lp_h * schedule.lp_w
    cur = coeffs[..., :lp_n].reshape(batch + (channels, schedule.lp_h, schedule.lp_w))
    cur = cur.contiguous()
    off = lp_n

    for lvl in reversed(schedule.levels):
        hw, hh = lvl.target_w, lvl.target_h
        n = channels * (1 + 3 * hh * hw)
        chunk = coeffs[..., off : off + n].reshape(batch + (channels, 1 + 3 * hh * hw))
        off += n

        q = i32(chunk[..., 0]).reshape(batch + (channels, 1, 1, 1))
        quads = chunk[..., 1:].reshape(batch + (channels, 3, hh, hw))
        dequant = torch.where(q > 1, i16(i32(quads) * q), quads)
        c, b, d = (dequant[..., k, :, :].contiguous() for k in range(3))

        weff = effective_wavelet(wavelet, hw, hh)
        cur = unlift2d_level(weff, wrap, cur, b, c, d, lvl)

    return cur

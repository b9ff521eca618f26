"""Sharded-single-tile lifting: one tile's rows sharded over a mesh axis
(the port of ako_tpu/parallel/halo.py).

Each level whose V pass shards (`plan_levels`, as ako_tpu's) runs one K7
launch per non-empty shard: lift_kernels.lift_level_rows /
unlift_level_rows, the row-window instances of csrc/lift_level.cu, whose
row axis keeps the whole level's global pair indices, so that the edge
rules apply where the true edge lies. Shard s of a sharded level owns the
pairs [s m, min((s + 1) m, T)) of its T, m = ceil(T / n): the last shards
may be partial or empty, as in ako_tpu's plan, and an empty one launches
nothing.

What ako_tpu's shard_map programs take from their neighbours by a cyclic
lax.ppermute, the port copies: `_fill_rows` builds a shard's window, the
level's rows of its pairs and their halo (3 pairs for DD 13/7, 1 for
CDF 5/3, 0 for Haar; lift_kernels.row_window), clipped to the line or
for REPEAT taken modulo the pairs, out of whichever shards own those
rows, into a separate allocation on the shard's device, on the shard's
stream, after an event from each source's stream. The same copies
reshard between levels (m changes per level), and gather the shards'
rows of each quadrant into the output stream. Shards may be ragged, so
ako_tpu's crafted pads and boundary fixes (_pad_fwd, _pad_inv,
_fix_fwd, _fix_inv), which exist because shard_map needs equal blocks,
have no counterpart. A window never aliases another shard's storage,
even on one device: the copies that several cards need are the copies
one card makes.

The levels too small to shard run replicated on the axis's first device
through the port's one-device route (lift_kernels.forward_levels up to
pyramid_start, then forward_pyramid; the inverse likewise), writing
straight into the stream. Copies between cards go through Tensor.copy_
(peer to peer where the cards allow it); nothing here needs a collective.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ako_tpu_torch.core.geometry import LiftLevel, LiftSchedule
from ako_tpu_torch.core.settings import Color, Wavelet, Wrap
from ako_tpu_torch.ops import lift_kernels as lk
from ako_tpu_torch.ops import lifting
from ako_tpu_torch.ops.wavelets import effective_wavelet
from ako_tpu_torch.parallel.mesh import Caller, Mesh, Shard
from ako_tpu_torch.runtime.kernels import count_launch

# Minimum evens a shard must keep for the DD137 V-stencil's MIRROR /
# second-tap substitutions and ppermute halo slices to stay local.
_MIN_LOCAL_EVENS = 4

#: copies made by the sharded lift (window rows and reshards, gathers
#: into the output), counted as the kernels' launches are
COPIES = {"window": 0, "gather": 0}


class _Plan(NamedTuple):
    m: int  # evens per shard (local rows = 2m)
    pad_pairs: int  # (even, odd) pad pairs appended after the valid 2T rows


def _shard_plan(lvl: LiftLevel, n: int) -> Optional[_Plan]:
    """Wrap- and wavelet-independent since r5: every ragged level
    shards (CLAMP/ZERO via crafted pads, MIRROR/REPEAT via pad+fix,
    Haar trivially); only the minimum-local-evens bound replicates."""
    T = lvl.target_h
    m = -(-T // n)
    if m < _MIN_LOCAL_EVENS:
        return None
    return _Plan(m, m * n - T)


def plan_levels(
    schedule: LiftSchedule, n_shards: int, wavelet: Wavelet, wrap: Wrap
) -> List[bool]:
    """Static per-level shard decision for a schedule on an
    `n_shards`-way row mesh — True where the level's V pass runs
    sharded. Mirrors forward_tile_sharded's planning exactly (the
    forward stays sharded monotonically; once a level replicates, the
    smaller remainder stays replicated)."""
    out = []
    sharded = True
    for lvl in schedule.levels:
        sharded = sharded and _shard_plan(lvl, n_shards) is not None
        out.append(sharded)
    return out


def shard_pairs(T: int, n: int) -> List[Tuple[int, int]]:
    """Each shard's pairs [p0, p1) of a level of T pairs over n shards:
    m = ceil(T / n) each, the last ones partial or empty (p0 == p1)."""
    m = -(-T // n)
    return [(min(s * m, T), min((s + 1) * m, T)) for s in range(n)]


class _Rows(NamedTuple):
    """Rows [lo, hi) of a plane (along dim -2 of t), held by a shard and
    ready after `event` on its stream."""

    lo: int
    hi: int
    t: torch.Tensor
    shard: Shard
    event: object


def _copy(dst, dst_shard: Shard, src, src_shard: Shard, event, kind: str) -> None:
    """dst.copy_(src), after `event` (the source's writer) and before the
    work enqueued later on dst_shard's stream."""
    count_launch(COPIES, kind)
    if dst.device == src.device:
        dst_shard.wait(event)
        with dst_shard.use():
            dst.copy_(src, non_blocking=True)
        if src_shard.stream is not None and src_shard.stream != dst_shard.stream:
            src.record_stream(dst_shard.stream)  # read there: not reused before it is done
    else:
        # Tensor.copy_ between two cards runs on the source card's current
        # stream, between barriers with the destination card's current one
        with src_shard.use(), dst_shard.use():
            dst.copy_(src, non_blocking=True)


def _fill_rows(dst, shard: Shard, parts: Sequence[_Rows], rows: Sequence[int],
               kind: str = "window") -> None:
    """dst[..., i, :] = row rows[i] of the plane the parts hold: one copy
    per run of consecutive rows within one part, on `shard`'s stream."""
    i = 0
    while i < len(rows):
        r = rows[i]
        part = next(p for p in parts if p.lo <= r < p.hi)
        j = i + 1
        while j < len(rows) and rows[j] == rows[j - 1] + 1 and rows[j] < part.hi:
            j += 1
        _copy(dst[..., i:j, :], shard, part.t[..., r - part.lo : r - part.lo + j - i, :],
              part.shard, part.event, kind)
        i = j


def window_pairs(win_lo: int, win_n: int, T: int, wrap: Wrap) -> List[int]:
    """The level's pair at each window pair: pair p, or p modulo T for
    REPEAT."""
    return [p % T if wrap == Wrap.REPEAT else p for p in range(win_lo, win_lo + win_n)]


def window_rows(win_lo: int, win_n: int, lvl: LiftLevel, wrap: Wrap) -> List[int]:
    """The plane's row at each row of a forward window: two a pair, an
    odd height's fake odd row its last even one."""
    return [min(2 * p + odd, lvl.current_h - 1)
            for p in window_pairs(win_lo, win_n, lvl.target_h, wrap) for odd in (0, 1)]


def _empty(shard: Shard, shape):
    with shard.use():
        return torch.empty(shape, dtype=torch.int16, device=shard.device)


def forward_tile_sharded(
    planes,
    schedule: LiftSchedule,
    wavelet: Wavelet,
    wrap: Wrap,
    qg: Sequence[Tuple[Tuple[int, ...], Tuple[int, ...]]],
    mesh: Mesh,
    axis_name: str = "rows",
):
    """Row-sharded forward_tile: planes (channels, tile_h, tile_w) int16
    -> serialized stream (coeff_count,) int16 on the axis's first device,
    identical to ops.lifting.forward_tile's output."""
    shards = mesh.shards(axis_name)
    C = planes.shape[-3]
    home = Caller(shards[0].device)
    ks = sum(plan_levels(schedule, len(shards), wavelet, wrap))
    if ks == 0:
        return lifting.forward_tile(planes.to(home.device).contiguous(), schedule, wavelet, wrap, qg)
    out = _empty(home, (schedule.coeff_count(C),))
    offs = lk.level_offsets(schedule, C)
    src = Caller(planes.device)
    parts = [_Rows(0, planes.shape[-2], planes, src, src.record())]
    for k in range(ks):
        lvl = schedule.levels[k]
        T, tw = lvl.target_h, lvl.target_w
        weff = effective_wavelet(wavelet, tw, T)
        chunk = out[offs[k] : offs[k] + C * (1 + 3 * T * tw)].view(C, 1 + 3 * T * tw)
        quads = chunk[:, 1:].view(C, 3, T, tw)
        level_parts = []
        for shard, (p0, p1) in zip(shards, shard_pairs(T, len(shards))):
            if p0 == p1:
                continue
            win_lo, win_n = lk.row_window(T, (p0, p1), weff, wrap)
            win = _empty(shard, (C, 2 * win_n, lvl.current_w))
            _fill_rows(win, shard, parts, window_rows(win_lo, win_n, lvl, wrap))
            with shard.use():
                ll, rows = lk.lift_level_rows(win, schedule, k, (p0, p1), win_lo, wavelet, wrap, qg)
            ev = shard.record()
            level_parts.append(_Rows(p0, p1, ll, shard, ev))
            # the shard's rows of each quadrant to their wire offsets; the q
            # heads from the shard that owns pair 0
            rv = rows.view(C, 1 + 3 * (p1 - p0) * tw)
            _copy(quads[:, :, p0:p1], home, rv[:, 1:].view(C, 3, p1 - p0, tw), shard, ev, "gather")
            if p0 == 0:
                _copy(chunk[:, :1], home, rv[:, :1], shard, ev, "gather")
        parts = level_parts
    if ks == len(schedule.levels):
        _fill_rows(lk.lp_view(out.view(1, -1), schedule, C)[0], home, parts, range(schedule.lp_h),
                   "gather")
        return out
    # the first replicated level gathers the LL on the first device
    lvl = schedule.levels[ks]
    x = _empty(home, (1, C, lvl.current_h, lvl.current_w))
    _fill_rows(x[0], home, parts, range(lvl.current_h), "gather")
    start = lk.pyramid_start(schedule, C)
    stream = out.view(1, -1)
    if start is None or ks < start:
        stop = len(schedule.levels) if start is None else start
        x = lk.forward_levels(x, stream, schedule, range(ks, stop), wavelet, wrap, qg, Color.NONE,
                              False)
    if start is not None:
        lk.forward_pyramid(x, stream, schedule, max(start, ks), wavelet, wrap, qg, Color.NONE,
                           False)
    return out


def inverse_tile_sharded(
    coeffs,
    schedule: LiftSchedule,
    wavelet: Wavelet,
    wrap: Wrap,
    channels: int,
    mesh: Mesh,
    axis_name: str = "rows",
):
    """Row-sharded inverse_tile: serialized stream -> planes
    (channels, tile_h, tile_w) int16 on the axis's first device,
    identical to ops.lifting.inverse_tile's output."""
    shards = mesh.shards(axis_name)
    C = channels
    home = Caller(shards[0].device)
    coeffs = coeffs.to(home.device).contiguous()
    L = len(schedule.levels)
    ks = sum(plan_levels(schedule, len(shards), wavelet, wrap))
    if ks == 0:
        return lifting.inverse_tile(coeffs, schedule, wavelet, wrap, C)
    stream = coeffs.view(1, -1)
    start = lk.pyramid_start(schedule, C)
    inv = (wavelet, wrap, C, Color.NONE)
    if ks == L:
        cur = lk.lp_view(stream, schedule, C)
    elif start is None:
        cur = lk.inverse_levels(lk.lp_view(stream, schedule, C), stream, schedule, range(ks, L), *inv)
    elif ks < start:
        cur = lk.inverse_levels(lk.inverse_pyramid(stream, schedule, start, *inv), stream, schedule,
                                range(ks, start), *inv)
    else:
        cur = lk.inverse_pyramid(stream, schedule, ks, *inv)
    ready = home.record()
    parts = [_Rows(0, cur.shape[-2], cur[0], home, ready)]
    offs = lk.level_offsets(schedule, C)
    for k in reversed(range(ks)):
        lvl = schedule.levels[k]
        T, tw = lvl.target_h, lvl.target_w
        weff = effective_wavelet(wavelet, tw, T)
        chunk = coeffs[offs[k] : offs[k] + C * (1 + 3 * T * tw)].view(C, 1 + 3 * T * tw)
        quads = [_Rows(0, T, chunk[:, 1:].view(C, 3, T, tw), home, ready)]
        level_parts = []
        for shard, (p0, p1) in zip(shards, shard_pairs(T, len(shards))):
            if p0 == p1:
                continue
            win_lo, win_n = lk.row_window(T, (p0, p1), weff, wrap)
            pairs = window_pairs(win_lo, win_n, T, wrap)
            ll = _empty(shard, (C, win_n, tw))
            win = _empty(shard, (C * (1 + 3 * win_n * tw),))
            wv = win.view(C, 1 + 3 * win_n * tw)
            _fill_rows(ll, shard, parts, pairs)
            _fill_rows(wv[:, 1:].view(C, 3, win_n, tw), shard, quads, pairs)
            _copy(wv[:, :1], shard, chunk[:, :1], home, ready, "window")
            with shard.use():
                rows = lk.unlift_level_rows(ll, win, schedule, k, (p0, p1), win_lo, wavelet, wrap)
            level_parts.append(_Rows(2 * p0, 2 * p0 + rows.shape[1], rows, shard, shard.record()))
        parts = level_parts
    out = _empty(home, (C, schedule.tile_h, schedule.tile_w))
    _fill_rows(out, home, parts, range(schedule.tile_h), "gather")
    return out

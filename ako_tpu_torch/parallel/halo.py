"""Sharded-single-tile lifting: one tile's rows sharded over a mesh axis
(the port of ako_tpu/parallel/halo.py).

Shard s of a sharded level (`plan_levels`, as ako_tpu's) owns the pairs
[s m, min((s + 1) m, T)) of its T, m = ceil(T / n): the last shards may be
partial or empty, as in ako_tpu's plan. Each sharded level runs one K7
launch per device over that device's non-empty shards
(lift_kernels.lift_level_shards / unlift_level_shards, the shard-table
instances of csrc/lift_level.cu), on the stream of the device's first
shard, after an event from each source. The kernel's row axis keeps the
whole level's global pair indices, so the edge rules apply where the true
edge lies and REPEAT's halo is taken modulo the pairs; ragged or empty
shards need nothing, so ako_tpu's crafted pads and boundary fixes
(_pad_fwd, _pad_inv, _fix_fwd, _fix_inv), which exist because shard_map
needs equal blocks, have no counterpart.

What ako_tpu's shard_map programs take from their neighbours by a cyclic
lax.ppermute, a launch reads in place: each of its sources is one segment,
a buffer of its device at the source's full height that holds its shards'
rows (the input planes, each level's LL or plane, one buffer a device and
level) or, on the device of the axis's first shard (home), the stream.
Only rows held on another device are copied: the rows of the device's
windows (each shard's pairs and their halo, 3 pairs for DD 13/7, 1 for
CDF 5/3, 0 for Haar; lift_kernels.row_window) that lie there, one copy per
run of rows, into that buffer at their own rows (a new one where the
device holds none of the source). The forward writes C, B, D and the
q heads straight to their wire offsets on home, and each level's LL to
its device's buffer, which on home is the next replicated level's input
or the stream's LP head; the inverse writes each level's plane to its
device's buffer, at level 0 straight into the output on home. A device
other than home writes into buffers of its own, gathered to home by one
copy per run of rows. So on one card a call copies nothing.

The levels too small to shard run replicated on home through the port's
one-device route (lift_kernels.forward_levels up to pyramid_start, then
forward_pyramid; the inverse likewise), writing straight into the stream.
Copies between cards go through Tensor.copy_ (peer to peer where the cards
allow it); nothing here needs a collective.
"""

from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ako_tpu_torch.core.geometry import LiftLevel, LiftSchedule
from ako_tpu_torch.core.settings import Color, Wavelet, Wrap
from ako_tpu_torch.ops import lift_kernels as lk
from ako_tpu_torch.ops import lifting
from ako_tpu_torch.ops.lift_kernels import Segment, pair_runs
# the windows' pairs and rows, as ako_tpu_torch.parallel.halo names them
from ako_tpu_torch.ops.lift_kernels import window_pairs, window_rows  # noqa: F401
from ako_tpu_torch.ops.wavelets import effective_wavelet
from ako_tpu_torch.parallel.mesh import Caller, Mesh, Shard
from ako_tpu_torch.runtime.kernels import MAX_SHARDS, count_launch

# Minimum evens a shard must keep for the DD137 V-stencil's MIRROR /
# second-tap substitutions and ppermute halo slices to stay local.
_MIN_LOCAL_EVENS = 4

#: copies made by the sharded lift (rows of another device into a
#: launch's source buffer at their own rows, and gathers into home's
#: outputs), counted as the kernels' launches are
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


def _device_key(shard: Shard):
    """What shards are grouped by into one launch: their device. Shards of
    one device read each other's rows in place."""
    return shard.device


def _check_mesh(shards: Sequence[Shard]) -> None:
    """A device's launch takes at most MAX_SHARDS shards: a mesh with more
    on one device is refused before any launch. (Its segments are one a
    source, whatever the mesh.)"""
    counts: dict = {}
    for shard in shards:
        key = _device_key(shard)
        counts[key] = counts.get(key, 0) + 1
    if max(counts.values()) > MAX_SHARDS:
        raise ValueError(f"a row-sharded lift takes at most {MAX_SHARDS} shards a device, got "
                         f"{max(counts.values())}")


class _Group(NamedTuple):
    """A device's non-empty shards of a level: its grouping key, the shard
    whose stream launches, and the shards' pairs in order."""

    key: object
    launch: Shard
    pairs: Tuple[Tuple[int, int], ...]


def _groups(shards: Sequence[Shard], T: int) -> List[_Group]:
    """The level's non-empty shards grouped by _device_key, in order of
    each device's first shard."""
    groups: dict = {}
    for shard, (p0, p1) in zip(shards, shard_pairs(T, len(shards))):
        if p0 < p1:
            key = _device_key(shard)
            launch, pairs = groups.get(key, (shard, ()))
            groups[key] = (launch, pairs + ((p0, p1),))
    return [_Group(key, launch, pairs) for key, (launch, pairs) in groups.items()]


class _Rows(NamedTuple):
    """Rows [lo, hi) (along dim -2) of buf, a buffer of a plane's rows from
    row 0 on the device of grouping key `key`, written by `shard`'s stream
    and ready after `event`. The parts of one device and source are runs
    of one buffer."""

    lo: int
    hi: int
    buf: torch.Tensor
    shard: Shard
    event: object
    key: object

    def rows(self):
        return self.buf.narrow(-2, self.lo, self.hi - self.lo)


def _merged(runs) -> List[Tuple[int, int]]:
    """Runs [a, b) sorted, overlapping or adjacent ones merged."""
    out: List[Tuple[int, int]] = []
    for a, b in sorted(runs):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _used_on(t, shard: Shard) -> None:
    """t is read or written on shard's stream: not reused before that
    stream is done with it."""
    if shard.stream is not None:
        t.record_stream(shard.stream)


def _copy(dst, dst_shard: Shard, src, src_shard: Shard, event, kind: str) -> None:
    """dst.copy_(src), after `event` (the source's writer) and before the
    work enqueued later on dst_shard's stream."""
    count_launch(COPIES, kind)
    if dst.device == src.device:
        dst_shard.wait(event)
        with dst_shard.use():
            dst.copy_(src, non_blocking=True)
        _used_on(src, dst_shard)
    else:
        # Tensor.copy_ between two cards runs on the source card's current
        # stream, between barriers with the destination card's current one
        with src_shard.use(), dst_shard.use():
            dst.copy_(src, non_blocking=True)


def _empty(shard: Shard, shape):
    with shard.use():
        return torch.empty(shape, dtype=torch.int16, device=shard.device)


def _source(g: _Group, parts: Sequence[_Rows], need, shape: tuple) -> List[Segment]:
    """The one segment of a source, rows from 0, that a launch of group g
    reads: the buffer of g's device that the parts on it are runs of (their
    writers' events waited for on g's stream), else a new one of `shape`;
    the rows need() (runs [a, b), merged; asked for only when a part lies
    on another device) that another device's parts hold are copied into it
    at their own rows, one copy per run."""
    own = [part for part in parts if part.key == g.key]
    for part in own:
        g.launch.wait(part.event)
    buf = own[0].buf if own else _empty(g.launch, shape)
    _used_on(buf, g.launch)
    for part in parts:
        if part.key != g.key:
            for a, b in need():
                a, b = max(a, part.lo), min(b, part.hi)
                if a < b:
                    _copy(buf.narrow(-2, a, b - a), g.launch, part.buf.narrow(-2, a, b - a),
                          part.shard, part.event, "window")
    return [Segment(0, buf)]


def _window_runs(g: _Group, lvl: LiftLevel, weff: Wavelet, wrap: Wrap,
                 rows: bool) -> List[Tuple[int, int]]:
    """The pairs of g's windows (row_window), as merged runs of the line's
    pairs, or (rows) of the plane's rows."""
    runs = []
    for pr in g.pairs:
        lo, wn = lk.row_window(lvl.target_h, pr, weff, wrap)
        runs += pair_runs(lo, lo + wn, lvl.target_h, wrap)
    if rows:
        runs = [(2 * a, min(2 * b, lvl.current_h)) for a, b in runs]
    return _merged(runs)


def _gather(dst, home: Shard, home_key, parts: Sequence[_Rows]) -> None:
    """dst's rows (along dim -2, from row 0) that parts on other devices
    than home hold, one copy per part (a run of rows)."""
    for part in parts:
        if part.key != home_key:
            _copy(dst.narrow(-2, part.lo, part.hi - part.lo), home, part.rows(), part.shard,
                  part.event, "gather")


def _own_parts(g: _Group, buf, rows, event) -> List[_Rows]:
    """The runs of rows [a, b) of buf (along dim -2, from row 0) that g's
    launch wrote, as parts."""
    return [_Rows(a, b, buf, g.launch, event, g.key) for a, b in _merged(rows)]


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
    planes = planes.to(home.device).contiguous()
    ks = sum(plan_levels(schedule, len(shards), wavelet, wrap))
    if ks == 0:
        return lifting.forward_tile(planes, schedule, wavelet, wrap, qg)
    _check_mesh(shards)
    L = len(schedule.levels)
    home_key = _device_key(shards[0])
    out = _empty(home, (schedule.coeff_count(C),))
    offs = lk.level_offsets(schedule, C)
    parts = [_Rows(0, planes.shape[-2], planes, home, home.record(), home_key)]
    for k in range(ks):
        lvl = schedule.levels[k]
        T, tw, w = lvl.target_h, lvl.target_w, lvl.current_w
        weff = effective_wavelet(wavelet, tw, T)
        n = C * (1 + 3 * T * tw)
        quads = out[offs[k] : offs[k] + n].view(C, 1 + 3 * T * tw)[:, 1:].view(C, 3, T, tw)
        level_parts = []
        for g in _groups(shards, T):
            segs = _source(g, parts, partial(_window_runs, g, lvl, weff, wrap, True),
                           (C, lvl.current_h, w))
            on_home = g.key == home_key
            # LL: the stream's LP head after the last level, else a buffer
            # of the device's (on home, the next replicated level's input)
            if on_home and k == L - 1:
                ll = lk.lp_view(out.view(1, -1), schedule, C)[0]
            else:
                ll = _empty(g.launch, (C, T, tw))
            chunk = out[offs[k] : offs[k] + n] if on_home else _empty(g.launch, (n,))
            with g.launch.use():
                lk.lift_level_shards(segs, schedule, k, g.pairs, ll, chunk, 0, wavelet, wrap, qg)
            for t in (ll, chunk):
                _used_on(t, g.launch)
            ev = g.launch.record()
            level_parts += _own_parts(g, ll, g.pairs, ev)
            if on_home:
                home.wait(ev)
                home_ll = ll
            else:
                # the device's rows of each quadrant to their wire offsets
                src = chunk.view(C, 1 + 3 * T * tw)[:, 1:].view(C, 3, T, tw)
                for a, b in _merged(g.pairs):
                    _copy(quads[:, :, a:b], home, src[:, :, a:b], g.launch, ev, "gather")
        parts = level_parts
    # home's LL of the last sharded level, the other devices' rows gathered
    # into it: the stream's LP head, or the first replicated level's input
    _gather(home_ll, home, home_key, parts)
    if ks == L:
        return out
    _used_on(home_ll, home)
    x = home_ll.unsqueeze(0)
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
    _check_mesh(shards)
    home_key = _device_key(shards[0])
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
    parts = [_Rows(0, cur.shape[-2], cur[0], home, ready, home_key)]
    offs = lk.level_offsets(schedule, C)
    out = _empty(home, (C, schedule.tile_h, schedule.tile_w))
    for k in reversed(range(ks)):
        lvl = schedule.levels[k]
        T, tw, h, w = lvl.target_h, lvl.target_w, lvl.current_h, lvl.current_w
        weff = effective_wavelet(wavelet, tw, T)
        cv = coeffs[offs[k] : offs[k] + C * (1 + 3 * T * tw)].view(C, 1 + 3 * T * tw)
        quads = [_Rows(0, T, cv[:, 1:].view(C, 3, T, tw), home, ready, home_key)]
        level_parts = []
        for g in _groups(shards, T):
            need = partial(_window_runs, g, lvl, weff, wrap, False)
            ll_segs = _source(g, parts, need, (C, T, tw))
            cbd_segs = _source(g, quads, need, (C, 3, T, tw))
            on_home = g.key == home_key
            if on_home:
                hd = cv[:, 0]
            else:
                hd = _empty(g.launch, (C, 1))
                _copy(hd, g.launch, cv[:, :1], home, ready, "window")
                hd = hd[:, 0]
            dst = out if on_home and k == 0 else _empty(g.launch, (C, h, w))
            with g.launch.use():
                lk.unlift_level_shards(ll_segs, cbd_segs, hd, schedule, k, g.pairs, dst, 0, wavelet,
                                       wrap)
            _used_on(dst, g.launch)
            ev = g.launch.record()
            if on_home:
                home.wait(ev)
            level_parts += _own_parts(g, dst, [(2 * a, min(2 * b, h)) for a, b in g.pairs], ev)
        parts = level_parts
    _gather(out, home, home_key, parts)
    return out

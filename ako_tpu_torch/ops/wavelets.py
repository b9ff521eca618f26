"""Separable integer lifting as plain torch ops: the plain versions of
the CUDA lift kernels (ops/lift_kernels.py), and the path a CPU tensor
takes.

Each 1-D pass operates on a whole batched plane at once: the scalar
row/column loops of the reference (library/wavelet-{cdf53,dd137,haar}.c)
become strided slices + elementwise ops, with the wrap-mode boundary
handling expressed as per-edge substitutions. Arithmetic is int32 with
an int16 cast at every point where the reference stores to a
coefficient array, so results are bit-exact including int16
wraparound. Same steps as ako_tpu/ops/wavelets.py without the sharded
halo exchange.

Lift formulas (Adams 2002 lifting forms, as used by the reference):
  CDF 5/3 : hp = odd - (even + even+1)/2 ; lp = even + (hp-1 + hp)/4
  DD 13/7 : hp = odd + (even-1 + even+2 - 9(even + even+1))/16
            lp = even + (-hp-2 - hp+1 + 9(hp-1 + hp))/32
  Haar    : lp = even ; hp = odd - even
with all divisions truncating toward zero.
"""

from __future__ import annotations

import torch

from ako_tpu_torch.core.settings import Wavelet, Wrap
from ako_tpu_torch.ops.intmath import div2, div4, div16, div32, i16, i32

# Axis conventions: the lifted axis is passed as -1 (H) or -2 (V).


def _sl(x, lo, hi, axis):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(lo, hi)
    return x[tuple(idx)]


def _stride2(x, start, axis):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, None, 2)
    return x[tuple(idx)]


def _zeros_like_edge(x, axis, n=1):
    return torch.zeros_like(_sl(x, 0, n, axis))


def _shift_prev(x, axis, wrap):
    """y[i] = x[i-1]; y[0] per wrap: CLAMP/MIRROR -> x[0], REPEAT -> x[-1],
    ZERO -> 0. (The reference uses the same first-tap substitution for
    CLAMP and MIRROR on +-1 neighbors.)"""
    if wrap == Wrap.REPEAT:
        head = _sl(x, -1, None, axis)
    elif wrap == Wrap.ZERO:
        head = _zeros_like_edge(x, axis)
    else:  # CLAMP, MIRROR
        head = _sl(x, 0, 1, axis)
    return torch.cat([head, _sl(x, 0, -1, axis)], dim=axis)


def _shift_next(x, axis, wrap):
    """y[i] = x[i+1]; y[-1] per wrap: CLAMP/MIRROR -> x[-1],
    REPEAT -> x[0], ZERO -> 0."""
    if wrap == Wrap.REPEAT:
        tail = _sl(x, 0, 1, axis)
    elif wrap == Wrap.ZERO:
        tail = _zeros_like_edge(x, axis)
    else:
        tail = _sl(x, -1, None, axis)
    return torch.cat([_sl(x, 1, None, axis), tail], dim=axis)


def _shift_prev2(x, axis, wrap):
    """y[i] = x[i-2]; first two per the reference's second-tap rules:
    CLAMP -> x[0], x[0]; MIRROR -> x[1], x[2]; REPEAT -> x[-2], x[-1];
    ZERO -> 0 (wavelet-dd137.c first-values cases)."""
    if wrap == Wrap.CLAMP:
        head = torch.cat([_sl(x, 0, 1, axis)] * 2, dim=axis)
    elif wrap == Wrap.MIRROR:
        head = _sl(x, 1, 3, axis)
    elif wrap == Wrap.REPEAT:
        head = _sl(x, -2, None, axis)
    else:
        head = _zeros_like_edge(x, axis, 2)
    return torch.cat([head, _sl(x, 0, -2, axis)], dim=axis)


def _shift_next2(x, axis, wrap):
    """y[i] = x[i+2]; last two per the reference's second-tap rules:
    CLAMP -> x[-1], x[-1]; MIRROR -> x[-3], x[-2]; REPEAT -> x[0], x[1];
    ZERO -> 0."""
    if wrap == Wrap.CLAMP:
        tail = torch.cat([_sl(x, -1, None, axis)] * 2, dim=axis)
    elif wrap == Wrap.MIRROR:
        tail = _sl(x, -3, -1, axis)
    elif wrap == Wrap.REPEAT:
        tail = _sl(x, 0, 2, axis)
    else:
        tail = _zeros_like_edge(x, axis, 2)
    return torch.cat([_sl(x, 2, None, axis), tail], dim=axis)


def _interleave(ev, od, axis):
    """Merge even/odd slots along `axis`; od may be one element shorter
    (the dropped fake slot)."""
    ax = axis % ev.ndim
    n_ev = ev.shape[ax]
    n_od = od.shape[ax]
    if n_ev == n_od:
        stacked = torch.stack([ev, od], dim=ax + 1)
        return stacked.reshape(ev.shape[:ax] + (2 * n_ev,) + ev.shape[ax + 1 :])
    # odd output length: interleave the first n_od pairs, append last even
    body = _interleave(_sl(ev, 0, n_od, axis), od, axis)
    return torch.cat([body, _sl(ev, -1, None, axis)], dim=axis)


# ---------------------------------------------------------------------
# Forward lifting


def lift_core(wavelet: Wavelet, wrap: Wrap, ev, od, axis: int):
    """Forward lift formulas on pre-split even/odd streams (int32),
    shifts along `axis`; returns (lp, hp) int16."""
    if wavelet == Wavelet.HAAR:
        return i16(ev), i16(od - ev)

    if wavelet == Wavelet.CDF53:
        ev_p1 = _shift_next(ev, axis, wrap)
        hp = i16(od - div2(ev + ev_p1))
        hp32 = i32(hp)
        hp_l1 = _shift_prev(hp32, axis, wrap)
        lp = i16(ev + div4(hp_l1 + hp32))
        return lp, hp

    # DD 13/7
    ev_l1 = _shift_prev(ev, axis, wrap)
    ev_p1 = _shift_next(ev, axis, wrap)
    ev_p2 = _shift_next2(ev, axis, wrap)
    hp = i16(od + div16(ev_l1 + ev_p2 - 9 * (ev + ev_p1)))
    hp32 = i32(hp)
    hp_l1 = _shift_prev(hp32, axis, wrap)
    hp_p1 = _shift_next(hp32, axis, wrap)
    hp_l2 = _shift_prev2(hp32, axis, wrap)
    lp = i16(ev + div32(-hp_l2 - hp_p1 + 9 * (hp_l1 + hp32)))
    return lp, hp


def lift1d(wavelet: Wavelet, wrap: Wrap, x, fake_last: int, axis: int):
    """One forward lift along `axis`. x is int16 of even-or-odd length
    2t - fake_last; returns (lp, hp), each int16 of length t.

    A fake trailing odd sample equal to the last even is fabricated when
    the source length is odd (library/lifting.c:46-47)."""
    ev = i32(_stride2(x, 0, axis))
    od = i32(_stride2(x, 1, axis))
    if fake_last:
        od = torch.cat([od, _sl(ev, -1, None, axis)], dim=axis)
    return lift_core(wavelet, wrap, ev, od, axis)


def lift2d(wavelet_eff: Wavelet, wrap: Wrap, x, level):
    """One full 2-D lift step on plane(s) x of shape (..., current_h,
    current_w) int16. Returns quadrants (ll, b, c, d), each
    (..., target_h, target_w) int16: b/c/d are the horizontal-detail,
    vertical-detail and diagonal quadrants in the reference's naming
    (library/lifting.c:250-263).

    Matches sLift2d (library/lifting.c:43-76): H pass first (with a
    duplicated last row when current_h is odd), then V pass."""
    if level.fake_last_row:
        x = torch.cat([x, _sl(x, -1, None, -2)], dim=-2)
    lp_h, hp_h = lift1d(wavelet_eff, wrap, x, level.fake_last_col, axis=-1)
    ll, c = lift1d(wavelet_eff, wrap, lp_h, 0, axis=-2)
    b, d = lift1d(wavelet_eff, wrap, hp_h, 0, axis=-2)
    return ll, b, c, d


def vlift(wavelet: Wavelet, wrap: Wrap, x, axis: int = -2):
    """Forward lift along `axis` of planes x (..., h, w) int16 -> (lp,
    hp): along the rows (axis -2) each (..., ceil(h/2), w), along the
    columns (axis -1) each (..., h, ceil(w/2)), int16. An odd length gets
    the fake last odd sample (the last even one): the V-only level of the
    split wiring (ako_tpu/ops/pallas_lift.py _vlift), on any length;
    along -1 it is vlift of the transposed planes, transposed back."""
    return lift1d(wavelet, wrap, x, x.shape[axis] % 2, axis=axis)


# ---------------------------------------------------------------------
# Inverse lifting


def unlift1d_pair(wavelet: Wavelet, wrap: Wrap, lp, hp, axis: int):
    """Inverse lift along `axis`: returns (evens, odds), each the same
    length as lp/hp, int16. Interleaving/truncation is the caller's
    concern (the V pass keeps them separate, the H pass merges)."""
    lp32 = i32(lp)
    hp32 = i32(hp)

    if wavelet == Wavelet.HAAR:
        return i16(lp32), i16(lp32 + hp32)

    if wavelet == Wavelet.CDF53:
        hp_l1 = _shift_prev(hp32, axis, wrap)
        ev = i16(lp32 - div4(hp_l1 + hp32))
        ev32 = i32(ev)
        ev_p1 = _shift_next(ev32, axis, wrap)
        od = i16(hp32 + div2(ev32 + ev_p1))
        return ev, od

    hp_l1 = _shift_prev(hp32, axis, wrap)
    hp_p1 = _shift_next(hp32, axis, wrap)
    hp_l2 = _shift_prev2(hp32, axis, wrap)
    ev = i16(lp32 - div32(-hp_l2 - hp_p1 + 9 * (hp_l1 + hp32)))
    ev32 = i32(ev)
    ev_l1 = _shift_prev(ev32, axis, wrap)
    ev_p1 = _shift_next(ev32, axis, wrap)
    ev_p2 = _shift_next2(ev32, axis, wrap)
    od = i16(hp32 - div16(ev_l1 + ev_p2 - 9 * (ev32 + ev_p1)))
    return ev, od


def vunlift(wavelet: Wavelet, wrap: Wrap, lp, hp, out_len: int, axis: int = -2):
    """Inverse of vlift: lp, hp (..., th, w) -> rows interleaved into
    (..., out_len, w) int16 (axis -2), or (..., h, tw) -> columns
    interleaved into (..., h, out_len) (axis -1); out_len = 2*t or
    2*t - 1 (the fake last sample dropped)."""
    ev, od = unlift1d_pair(wavelet, wrap, lp, hp, axis=axis)
    if out_len % 2:
        od = _sl(od, 0, -1, axis)
    return _interleave(ev, od, axis=axis)


def unlift2d(wavelet_eff: Wavelet, wrap: Wrap, ll, b, c, d, level):
    """Inverse of lift2d: quadrants (..., hp_h, hp_w) -> plane
    (..., current_h, current_w) int16.

    Mirrors s2dUnliftHp (library/lifting.c:104-148): two V unlifts
    (left half from ll/c, right half from b/d), then H unlifts for the
    even and odd row streams, dropping the fake last column/row."""
    ev_l, od_l = unlift1d_pair(wavelet_eff, wrap, ll, c, axis=-2)
    ev_r, od_r = unlift1d_pair(wavelet_eff, wrap, b, d, axis=-2)

    rows_even = _unlift_h_merge(wavelet_eff, wrap, ev_l, ev_r, level.fake_last_col)
    if level.fake_last_row:
        od_l = _sl(od_l, 0, -1, -2)
        od_r = _sl(od_r, 0, -1, -2)
    rows_odd = _unlift_h_merge(wavelet_eff, wrap, od_l, od_r, level.fake_last_col)

    return _interleave(rows_even, rows_odd, axis=-2)


def _unlift_h_merge(wavelet_eff, wrap, lp, hp, ignore_last):
    ev, od = unlift1d_pair(wavelet_eff, wrap, lp, hp, axis=-1)
    if ignore_last:
        od = _sl(od, 0, -1, -1)
    return _interleave(ev, od, axis=-1)


def effective_wavelet(wavelet: Wavelet, target_w: int, target_h: int) -> Wavelet:
    """Levels smaller than 8x8 always use CDF 5/3 in DD137 mode
    (library/lifting.c:58,126). Haar never falls back."""
    if wavelet == Wavelet.DD137 and (target_w < 8 or target_h < 8):
        return Wavelet.CDF53
    return wavelet

"""The tiles and register windows of csrc/vlift.cu's K1v / K2v (the split
wiring's V-only lifts, along either axis of the stored plane), and the
split wiring through them, against the plain versions and ako_tpu under
JAX on the CPU.

The kernels run only on the card, so `emulate_vlift` / `emulate_vunlift`
repeat their arithmetic in numpy, CTA by CTA: the grid of CTAs (runs of 8
pairs along the lift axis, one a warp, across 32 lines, one a lane: rows,
or a strip of columns of one or more planes), each CTA's tile in shared
memory (its runs' samples and 3 or 4 pairs beyond, by 16-byte copies
where rows are a multiple of 8 samples, each checked to lie in its row,
aligned; REPEAT's wrapped samples taken modulo the pairs, the fake odd
sample as its even one; every slot outside the load poisoned), each
thread's window of registers read from the tile (every slot it reads for
a pair on the line checked to be loaded), the predict on the run and the
pairs the update reads, then the update (the inverse in reverse), with
fixed taps inside a line and lift_common.cuh tap()'s substitutions within
two pairs of its ends, each substituted tap checked to fall in the
window's range for its step, and the stores, each output stored once.
Inputs come from numpy seeds; every comparison is exact equality."""

import itertools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ako_tpu.ops import pallas_lift as ref_pallas
from ako_tpu.ops import wavelets as ref_wavelets
from ako_tpu_torch.core import geometry
from ako_tpu_torch.core.settings import Wavelet, Wrap
from ako_tpu_torch.ops import lift_kernels as lk
from ako_tpu_torch.ops import wavelets
from ako_tpu_torch.runtime import kernels
from tests.test_torch_level_tiles import _tap, _w16

DD, CDF, HAAR = Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR
WAVELETS = [DD, CDF, HAAR]
AXES = (-1, -2)
# csrc/vlift.cu kRun, kLines, kMaxRuns, kSmem (test_kernel_constants_match_source)
RUN, LINES, MAX_RUNS, SMEM = 8, 32, 8, 10240
WIN = RUN + 6  # the run and 3 pairs on each side
SRC = os.path.join(os.path.dirname(kernels.__file__), "..", "csrc")


def _source(name):
    with open(os.path.join(SRC, name)) as f:
        return f.read()


def _weff(wavelet, pairs):
    """The wavelet a line of `pairs` pairs takes: DD 13/7's second taps
    need three pairs (the codec lifts DD 13/7 only on levels of 8 or more,
    ops/wavelets.effective_wavelet)."""
    return CDF if wavelet == DD and pairs < 3 else wavelet


def _div(x, s):
    """C's truncating x / 2^s in the bias-and-shift form."""
    return (x + np.where(x < 0, (1 << s) - 1, 0)) >> s


def _line_pair(p, n, rep):
    """lift_common.cuh line_pair: REPEAT's modulo n, else p or -1."""
    if rep:
        return p % n
    return p if 0 <= p < n else -1


def _line_sample(s, length, rep):
    """lift_common.cuh line_sample: the pair by _line_pair, the fake odd
    sample of an odd length its even one."""
    p = _line_pair(s >> 1, (length + 1) // 2, rep)
    return -1 if p < 0 else min(2 * p + (s & 1), length - 1)


def _lines(planes, axis):
    """The (lines, length) view of (n, h, w) planes along `axis`: rows of
    the (n * h, w) array, or each plane's columns, plane by plane."""
    n, h, w = planes.shape
    return planes.reshape(n * h, w) if axis == -1 else planes.transpose(0, 2, 1).reshape(n * w, h)


def _unlines(lines, n, h, w, axis):
    return lines.reshape(n, h, w) if axis == -1 else lines.reshape(n, w, h).transpose(0, 2, 1)


class Geometry:
    """csrc/vlift.cu Geometry: a call's CTAs."""

    def __init__(self, n, h, w, axis):
        self.n_, self.h, self.w, self.axis = n, h, w, axis
        self.len = w if axis == -1 else h
        self.n = (self.len + 1) // 2
        self.runs = -(-self.n // RUN)
        self.rc = min(self.runs, MAX_RUNS)
        self.rblocks = -(-self.runs // self.rc)
        if axis == -1:
            self.strips = self.pc = self.pp = 1
            self.lblocks = -(-(n * h) // LINES)
        else:
            self.strips = -(-w // LINES)
            self.pc = LINES if w >= LINES else -(-w // 8) * 8
            self.pp = LINES // self.pc
            self.lblocks = -(-n // self.pp) * self.strips

    def ctas(self):
        return self.lblocks * self.rblocks

    def block(self, bx):
        """csrc/vlift.cu Block: (a0, the CTA's lanes' lines as _lines
        indices, None for an idle lane, and its columns' first and count)."""
        rb, lb = bx % self.rblocks, bx // self.rblocks
        a0 = rb * self.rc * RUN
        if self.axis == -1:
            l0 = lb * LINES
            lines = min(LINES, self.n_ * self.h - l0)
            return a0, [l0 + i if i < lines else None for i in range(LINES)], 0, 1
        strip = lb % self.strips
        p0, c0 = (lb // self.strips) * self.pp, strip * LINES
        planes, cols = min(self.pp, self.n_ - p0), min(self.pc, self.w - c0)
        lanes = []
        for lane in range(LINES):  # lane -> (plane q, column c)
            q, c = lane // self.pc, lane % self.pc
            lanes.append((p0 + q) * self.w + c0 + c if q < planes and c < cols else None)
        return a0, lanes, c0, cols

    def smem(self, fwd):
        """int16 of shared memory a CTA takes (the kernel's layouts)."""
        rc, pc, pp = self.rc, self.pc, self.pp
        if self.axis == -1:
            if fwd:
                return LINES * (16 * rc + 24) + 2 * LINES * 8 * (rc | 1)
            return 2 * LINES * 8 * ((rc + 2) | 1) + LINES * 8 * (2 * rc + 1)
        if fwd:
            return pp * (16 * rc + 12) * pc + 2 * pp * RUN * rc * pc
        return 2 * pp * (RUN * rc + 6) * pc + pp * 2 * RUN * rc * pc


class _Run:
    """csrc/vlift.cu Run: pairs [a, a + RUN) of a line of `length`
    samples (n pairs)."""

    def __init__(self, length, a, rep):
        self.len, self.n, self.a, self.rep = length, (length + 1) // 2, a, rep

    def inner_fwd(self):
        return self.rep or (self.a >= 4 and self.a + RUN + 3 <= self.n)

    def inner_inv(self):
        return self.rep or (self.a >= 3 and self.a + RUN + 4 <= self.n)


def _at_edge(k, n):
    """Within two pairs of a line's end, where tap() substitutes (a run at
    a line's end takes tap()'s pair for every tap: elsewhere it is the
    pair itself)."""
    return k < 2 or k >= n - 2


class _Window:
    """A step's window of values (lines, slots) for pairs base .. with a
    mask of the slots that hold a loaded pair of the line."""

    def __init__(self, vals, ok, base):
        self.v, self.ok, self.base = vals, ok, base

    def tap(self, k, d, lo, n, wrap, edge):
        """csrc/vlift.cu tap_at for the step at pair k: slot k + d inside a
        line; at an edge tap()'s pair, checked to lie in the step's range
        [k + lo, k + lo + 3] and on a loaded slot, or zero."""
        if not edge:
            m = k + d
        else:
            m = _tap(k, d, n, wrap)
            if m < 0:
                return 0
            if not 0 <= k < n:  # a pair off the line: a neighbour, never kept
                m = min(max(m, k + lo), k + lo + 3)
            assert k + lo <= m <= k + lo + 3, "a substituted tap outside the step's range"
        i = m - self.base
        assert 0 <= i < self.v.shape[1]
        if 0 <= k < n:
            assert self.ok[i], "a tap on a slot that holds no pair of the line"
        return self.v[:, i]


def _predict(wav, ev, o, k, n, wrap, edge, sign):
    """The predict (sign 1) or its undoing (sign -1) at pair k."""
    e0 = ev.tap(k, 0, -1, n, wrap, False)
    if wav == HAAR:
        return _w16(o - sign * e0)
    e1 = ev.tap(k, 1, -1, n, wrap, edge)
    if wav == CDF:
        return _w16(o - sign * _div(e0 + e1, 1))
    t = _div(ev.tap(k, -1, -1, n, wrap, edge) + ev.tap(k, 2, -1, n, wrap, edge) - 9 * (e0 + e1), 4)
    return _w16(o + sign * t)


def _update(wav, hp, k, n, wrap, edge):
    """The update's term at pair k (not Haar)."""
    h0 = hp.tap(k, 0, -2, n, wrap, False)
    l1 = hp.tap(k, -1, -2, n, wrap, edge)
    if wav == CDF:
        return _div(l1 + h0, 2)
    return _div(-hp.tap(k, -2, -2, n, wrap, edge) - hp.tap(k, 1, -2, n, wrap, edge)
                + 9 * (l1 + h0), 5)


def _chunk(s0, length):
    """A 16-byte copy of 8 samples from sample s0 of a row of `length`."""
    assert s0 % 8 == 0 and 0 <= s0 and s0 + 8 <= length, "a 16-byte copy outside its row"


def _tile(rng, lines, ids, origin, width, length, mapping, rep):
    """A CTA's input tile: for each lane's line, slot i holds the line's
    entry mapping(origin + i) (or stays poisoned at -1); the mask of the
    loaded slots."""
    tile = rng.integers(-32768, 32768, size=(len(ids), width))
    ok = np.zeros(width, bool)
    for i in range(width):
        m = mapping(origin + i, length, rep)
        if m >= 0:
            tile[:, i] = lines[ids, m]
            ok[i] = True
    return tile, ok


def emulate_vlift(x, wav, wrap, axis, aligned=True, seed=0):
    """K1v, CTA by CTA: x the (n, h, w) int16 planes -> (lp, hp) int64,
    each (n, ceil(h/2), w) along -2 or (n, h, ceil(w/2)) along -1. Each
    output sample is stored by exactly one thread."""
    rng = np.random.default_rng(seed)
    n_, h, w = x.shape
    g = Geometry(n_, h, w, axis)
    lines = _lines(x.astype(np.int64), axis)
    rep, npairs = wrap == Wrap.REPEAT, g.n
    lp, hp = np.zeros((len(lines), npairs), np.int64), np.zeros((len(lines), npairs), np.int64)
    stores = np.zeros((len(lines), npairs), np.int64)
    assert g.smem(True) <= SMEM
    for bx in range(g.ctas()):
        a0, lanes, c0, cols = g.block(bx)
        ids = [i for i in lanes if i is not None]
        # the tile: samples from 2 a0 - 8 (along -1: 16-byte aligned) or
        # 2 a0 - 6, through the last run's window
        origin, width = (2 * a0 - 8, 16 * g.rc + 16) if axis == -1 else (2 * a0 - 6, 16 * g.rc + 12)
        tile, ok = _tile(rng, lines, ids, origin, width, g.len, _line_sample, rep)
        vec = aligned and w % 8 == 0
        if axis == -1 and vec:
            for k in range(2 * g.rc + 2):
                if 0 <= origin + 8 * k and origin + 8 * k + 8 <= w:
                    _chunk(origin + 8 * k, w)
        elif vec:
            assert c0 % 8 == 0 and cols % 8 == 0  # whole 16-byte chunks of each tile row
        for warp in range(g.rc):
            r = _Run(g.len, a0 + RUN * warp, rep)
            a = r.a
            if a >= npairs:
                continue
            first = 2 * (a - 3) - origin  # the window's first slot in the tile
            assert first >= 0 and first + 2 * WIN <= width
            ev, od = tile[:, first : first + 2 * WIN : 2], tile[:, first + 1 : first + 2 * WIN : 2]
            wok = ok[first : first + 2 * WIN : 2] & ok[first + 1 : first + 2 * WIN : 2]
            edge = not r.inner_fwd()
            E = _Window(ev, wok, a - 3)
            hs = np.zeros((len(ids), RUN + 3), np.int64)
            hok = np.zeros(RUN + 3, bool)
            for j in range(RUN + 3):
                k = a - 2 + j
                if edge and not 0 <= k < npairs:
                    continue  # an edge run steps only on the line's pairs
                hs[:, j] = _predict(wav, E, od[:, j + 1], k, npairs, wrap, edge and _at_edge(k, npairs), 1)
                hok[j] = (0 <= k < npairs and wok[j + 1]) or rep
            H = _Window(hs, hok, a - 2)
            for j in range(RUN):
                k = a + j
                if k >= npairs:
                    continue
                e0 = ev[:, j + 3]
                lo = e0 if wav == HAAR else _w16(e0 + _update(wav, H, k, npairs, wrap,
                                                              edge and _at_edge(k, npairs)))
                lp[ids, k], hp[ids, k] = lo, hs[:, j + 2]
                stores[ids, k] += 1
    assert (stores == 1).all(), "the CTAs do not tile the outputs"
    out = (n_, h, npairs) if axis == -1 else (n_, npairs, w)
    return tuple(_unlines(v, *out, axis) for v in (lp, hp))


def emulate_vunlift(lp, hp, out_len, wav, wrap, axis, aligned=True, seed=0):
    """K2v, CTA by CTA: lp, hp (n, t, w) (axis -2) or (n, h, t) (axis -1)
    -> the (n, h, w) int64 planes, samples interleaved along the axis and
    the fake last one of an odd out_len dropped. Each output sample is
    stored by exactly one thread."""
    rng = np.random.default_rng(seed)
    n_ = lp.shape[0]
    h, w = (out_len, lp.shape[2]) if axis == -2 else (lp.shape[1], out_len)
    g = Geometry(n_, h, w, axis)
    Ls, Hs = _lines(lp.astype(np.int64), axis), _lines(hp.astype(np.int64), axis)
    rep, npairs = wrap == Wrap.REPEAT, g.n
    out = np.zeros((len(Ls), out_len), np.int64)
    stores = np.zeros((len(Ls), out_len), np.int64)
    assert g.smem(False) <= SMEM

    def pair(p, n, rep_):
        return _line_pair(p, n, rep_)

    for bx in range(g.ctas()):
        a0, lanes, c0, cols = g.block(bx)
        ids = [i for i in lanes if i is not None]
        # the tiles: pairs from a0 - 8 (along -1: 16-byte aligned) or a0 - 3
        origin, width = (a0 - 8, RUN * g.rc + 16) if axis == -1 else (a0 - 3, RUN * g.rc + 6)
        lt, ok = _tile(rng, Ls, ids, origin, width, npairs, pair, rep)
        ht, _ = _tile(rng, Hs, ids, origin, width, npairs, pair, rep)
        if axis == -1 and aligned and npairs % 8 == 0:
            for k in range(g.rc + 2):
                if 0 <= origin + 8 * k and origin + 8 * k + 8 <= npairs:
                    _chunk(origin + 8 * k, npairs)
        elif axis == -2 and aligned and w % 8 == 0:
            assert c0 % 8 == 0 and cols % 8 == 0
        for warp in range(g.rc):
            r = _Run(out_len, a0 + RUN * warp, rep)
            a = r.a
            if a >= npairs:
                continue
            first = a - 3 - origin
            assert first >= 0 and first + WIN <= width
            lo, hi, wok = lt[:, first : first + WIN], ht[:, first : first + WIN], ok[first : first + WIN]
            edge = not r.inner_inv()
            Hw = _Window(hi, wok, a - 3)
            es = np.zeros((len(ids), RUN + 3), np.int64)
            eok = np.zeros(RUN + 3, bool)
            for j in range(RUN + 3):
                k = a - 1 + j
                if edge and not 0 <= k < npairs:
                    continue
                l0 = lo[:, j + 2]
                es[:, j] = l0 if wav == HAAR else _w16(l0 - _update(wav, Hw, k, npairs, wrap,
                                                                    edge and _at_edge(k, npairs)))
                eok[j] = (0 <= k < npairs and wok[j + 2]) or rep
            Ew = _Window(es, eok, a - 1)
            for j in range(RUN):
                k = a + j
                if k >= npairs:
                    continue
                odd = _predict(wav, Ew, hi[:, j + 3], k, npairs, wrap, edge and _at_edge(k, npairs), -1)
                out[ids, 2 * k] = es[:, j + 1]
                stores[ids, 2 * k] += 1
                if 2 * k + 1 < out_len:
                    out[ids, 2 * k + 1] = odd
                    stores[ids, 2 * k + 1] += 1
    assert (stores == 1).all(), "the CTAs do not tile the plane"
    return _unlines(out, n_, h, w, axis)


# ---------------------------------------------------------------------
# The register windows against the plain version and JAX

# (n, h, w) of a call's planes: odd and even sides along both axes, 1-px
# and 2-px sides, 4x4 and 2x2 planes, rows of a multiple of 8 samples (the
# 16-byte loads and stores) beside odd ones, and lines of many runs, whose
# inner runs take fixed taps
PLANES = [(2, 37, 53), (3, 17, 9), (2, 1, 40), (2, 40, 1), (2, 2, 301), (1, 150, 260),
          (4, 4, 4), (3, 2, 2), (2, 21, 48), (2, 64, 64), (2, 5, 3), (2, 1, 1)]


def _ref_vlift(wav, wrap, x, axis):
    ref = ref_wavelets.lift1d(wav, wrap, jnp.asarray(x), x.shape[axis] % 2, axis=axis)
    return [np.asarray(r) for r in ref]


def _ref_vunlift(wav, wrap, lp, hp, out_len, axis):
    ev, od = ref_wavelets.unlift1d_pair(wav, wrap, jnp.asarray(lp), jnp.asarray(hp), axis=axis)
    if out_len % 2:
        od = od[:, :, :-1] if axis == -1 else od[:, :-1]
    return np.asarray(ref_wavelets._interleave(ev, od, axis=axis))


@pytest.mark.parametrize("wrap", list(Wrap), ids=[w.name for w in Wrap])
@pytest.mark.parametrize("wavelet", WAVELETS, ids=[w.name for w in WAVELETS])
@pytest.mark.parametrize("shape", PLANES, ids=[f"{n}x{h}x{w}" for n, h, w in PLANES])
def test_windows_match_reference(shape, wavelet, wrap):
    """K1v and K2v along both axes, every register outside a thread's load
    poisoned, rows by 16-byte accesses and one sample at a time, against
    wavelets.vlift / vunlift and ako_tpu's lift1d / unlift1d_pair."""
    n, h, w = shape
    rng = np.random.default_rng(n * 10000 + h * 100 + w)
    x = rng.integers(-32768, 32768, size=shape).astype(np.int16)
    for axis in AXES:
        length = w if axis == -1 else h
        wav = _weff(wavelet, (length + 1) // 2)
        fwd = [t.numpy() for t in wavelets.vlift(wav, wrap, torch.from_numpy(x), axis)]
        for got, ref in zip(fwd, _ref_vlift(wav, wrap, x, axis)):
            np.testing.assert_array_equal(got, ref)
        lp, hp = (rng.integers(-32768, 32768, size=fwd[0].shape).astype(np.int16) for _ in range(2))
        inv = wavelets.vunlift(wav, wrap, torch.from_numpy(lp), torch.from_numpy(hp), length,
                               axis).numpy()
        np.testing.assert_array_equal(inv, _ref_vunlift(wav, wrap, lp, hp, length, axis))
        # unaligned pointers take the one-sample loads and stores that rows
        # of other than a multiple of 8 samples take anyway
        for aligned in (True, False) if w % 8 == 0 else (True,):
            msg = f"axis {axis} aligned {aligned}"
            got = emulate_vlift(x, wav, wrap, axis, aligned)
            np.testing.assert_array_equal(got[0], fwd[0], err_msg=f"lp, {msg}")
            np.testing.assert_array_equal(got[1], fwd[1], err_msg=f"hp, {msg}")
            np.testing.assert_array_equal(emulate_vunlift(lp, hp, length, wav, wrap, axis, aligned),
                                          inv, err_msg=f"inverse, {msg}")


def _north_star_calls():
    """(n, h, w, axis, wavelet) of the split wiring's calls on the north
    star's 128-px tile group (80 RGBA tiles: 320 planes), level by level:
    K1v along -1 on the level's plane, then the two V calls along -2."""
    calls = []
    for lvl in geometry.lift_schedule(128, 128).levels:
        weff = wavelets.effective_wavelet(DD, lvl.target_w, lvl.target_h)
        calls.append((320, lvl.current_h, lvl.current_w, -1, weff))
        calls.append((320, lvl.current_h, lvl.target_w, -2, weff))
    return calls


@pytest.mark.parametrize("wrap", [Wrap.CLAMP, Wrap.REPEAT], ids=["CLAMP", "REPEAT"])
def test_north_star_levels_cut_to_few_planes(wrap):
    """The north star's split calls, emulated on 3 of their 320 planes,
    against the plain versions (held to ako_tpu above)."""
    rng = np.random.default_rng(int(wrap))
    for _, h, w, axis, wav in _north_star_calls():
        x = rng.integers(-32768, 32768, size=(3, h, w)).astype(np.int16)
        length = w if axis == -1 else h
        ref = [t.numpy() for t in wavelets.vlift(wav, wrap, torch.from_numpy(x), axis)]
        got = emulate_vlift(x, wav, wrap, axis)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r, err_msg=f"{(h, w, axis)}")
        lp, hp = (rng.integers(-32768, 32768, size=ref[0].shape).astype(np.int16) for _ in range(2))
        want = wavelets.vunlift(wav, wrap, torch.from_numpy(lp), torch.from_numpy(hp), length, axis)
        np.testing.assert_array_equal(emulate_vunlift(lp, hp, length, wav, wrap, axis), want.numpy())


def test_north_star_grid():
    """The north star's split calls on an H100: CTAs of up to 8 runs of 8
    pairs (a warp each) across 32 lines (a lane each), within the
    kernel's shared memory; a warp's lanes on one run."""
    got = [Geometry(n, h, w, axis).ctas() for n, h, w, axis, _ in _north_star_calls()]
    assert got == [1280, 640, 640, 320, 320, 160, 160, 80, 80, 80, 40, 80]
    threads = [LINES * Geometry(n, h, w, axis).rc for n, h, w, axis, _ in _north_star_calls()]
    assert threads == [256, 256, 128, 128, 64, 64, 32, 32, 32, 32, 32, 32]
    for n, h, w, axis, _ in _north_star_calls():
        g = Geometry(n, h, w, axis)
        assert g.smem(True) <= SMEM and g.smem(False) <= SMEM


def test_whole_tile_plane():
    """One 1024x1280 (w x h) plane, as the whole-image tile's level 0
    gives it, along both axes (DD 13/7, CLAMP along -1, REPEAT along -2)."""
    rng = np.random.default_rng(1024)
    x = rng.integers(-32768, 32768, size=(1, 1280, 1024)).astype(np.int16)
    for wrap, axis in ((Wrap.CLAMP, -1), (Wrap.REPEAT, -2)):
        got = emulate_vlift(x, DD, wrap, axis)
        for g, r in zip(got, _ref_vlift(DD, wrap, x, axis)):
            np.testing.assert_array_equal(g, r)
    assert Geometry(1, 1280, 1024, -1).ctas() == 40 * 8
    assert Geometry(1, 1280, 1024, -2).ctas() == 32 * 10


@pytest.mark.parametrize("wrap", list(Wrap), ids=[w.name for w in Wrap])
@pytest.mark.parametrize("hw", [(16, 20), (12, 8)], ids=["16x20", "12x8"])
def test_split_wiring_emulated_vs_pallas_split(monkeypatch, hw, wrap):
    """The split wiring as the kernels run it (K1v along -1, then both
    halves' V passes along -2; the inverse in reverse), emulated, against
    the Pallas V-only kernels in AKO_TPU_PALLAS_MODE=split (interpret
    mode) and the plain lift2d_level / unlift2d_level."""
    monkeypatch.setenv("AKO_TPU_PALLAS_MODE", "split")
    h, w = hw
    wav = DD if min(h, w) >= 16 else CDF
    rng = np.random.default_rng(h * w + int(wrap))
    x = rng.integers(-32768, 32768, size=(3, h, w)).astype(np.int16)
    lp, hp = (v.astype(np.int16) for v in emulate_vlift(x, wav, wrap, -1))
    ll, c = emulate_vlift(lp, wav, wrap, -2)
    b, d = emulate_vlift(hp, wav, wrap, -2)
    ref = ref_pallas.lift2d_pallas(wav, wrap, jnp.asarray(x))
    lvl = geometry.lift_schedule(w, h).levels[0]
    plain = lk.lift2d_level(wav, wrap, torch.from_numpy(x), lvl, "split")
    for got, r, p in zip((ll, b, c, d), ref, plain):
        np.testing.assert_array_equal(got, np.asarray(r))
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))

    quads = [rng.integers(-32768, 32768, size=(3, h // 2, w // 2)).astype(np.int16) for _ in range(4)]
    ll, b, c, d = quads
    left = emulate_vunlift(ll, c, h, wav, wrap, -2).astype(np.int16)
    right = emulate_vunlift(b, d, h, wav, wrap, -2).astype(np.int16)
    got = emulate_vunlift(left, right, w, wav, wrap, -1)
    ref = np.asarray(ref_pallas.unlift2d_pallas(wav, wrap, *map(jnp.asarray, quads)))
    np.testing.assert_array_equal(got, ref)
    plain = lk.unlift2d_level(wav, wrap, *map(torch.from_numpy, quads), lvl, "split")
    np.testing.assert_array_equal(plain.numpy(), ref)


# ---------------------------------------------------------------------
# The grid, tables and the wrappers


@pytest.mark.parametrize("axis", AXES)
def test_blocks_take_every_run_once(axis):
    """csrc/vlift.cu Geometry / Block on shapes with partial CTAs, strips
    and plane packs, one-column and one-row planes: every (line, run) of
    the call taken by exactly one (CTA, warp, lane), within the kernel's
    shared memory."""
    src = _source("vlift.cu")
    assert "pc = a.w >= kLines ? kLines : (a.w + 7) / 8 * 8;" in src
    assert "rc = runs < kMaxRuns ? runs : kMaxRuns;" in src
    for n, h, w in [(3, 17, 9), (1, 1, 1), (5, 1, 40), (2, 40, 1), (7, 33, 130), (9, 300, 12),
                    (2, 1280, 1024), (11, 5, 24)]:
        g = Geometry(n, h, w, axis)
        assert g.smem(True) <= SMEM and g.smem(False) <= SMEM
        taken = []
        for bx in range(g.ctas()):
            a0, lanes, _, _ = g.block(bx)
            for warp, line in itertools.product(range(g.rc), lanes):
                if line is not None and a0 + RUN * warp < g.n:
                    taken.append((line, (a0 + RUN * warp) // RUN))
        lines = n * (h if axis == -1 else w)
        assert sorted(taken) == sorted(itertools.product(range(lines), range(g.runs)))


def test_tile_layouts_fit_shared_memory():
    """Every layout of the kernels (each run count a CTA and each tile
    width of a strip) within kSmem, and kSmem and the CTA's threads as
    csrc/vlift.cu has them."""
    src = _source("vlift.cu")
    assert f"constexpr int kSmem = {SMEM};" in src
    assert f"constexpr int kLines = {LINES};" in src and f"constexpr int kMaxRuns = {MAX_RUNS};" in src
    assert "int16_t* olp = sm + kLines * ps;" in src and "const int ps = 16 * g.rc + 24" in src
    for h, w, axis in itertools.product((1, 9, 16, 31, 64, 127, 128, 129, 1000), (1, 3, 8, 12, 24, 31, 32,
                                                                                 33, 64, 1000), AXES):
        g = Geometry(2, h, w, axis)
        assert g.smem(True) <= SMEM and g.smem(False) <= SMEM
        assert g.pp * g.pc <= LINES


def test_vlift_args_table():
    """The kernels' table for the north star's level-1 H pass (320 planes
    of 64x64 along -1) and a two-call V pass."""
    a = lk._vlift_args(320, 64, 64, -1, DD, Wrap.MIRROR, 1)
    assert (a.n, a.h, a.w, a.axis, a.wavelet, a.wrap, a.groups) == (320, 64, 64, 1, DD, Wrap.MIRROR, 1)
    b = lk._vlift_args(320, 64, 32, -2, CDF, Wrap.ZERO, 2)
    assert (b.axis, b.wavelet, b.wrap, b.groups) == (0, CDF, Wrap.ZERO, 2)


def test_kernel_constants_match_source():
    """The threads, the run, the window's 3 pairs a side and the tables'
    fields are csrc/vlift.cu's; kernels.SOURCES builds vlift.cu, and
    lift2d.cu no longer holds K1v/K2v."""
    src = _source("vlift.cu")
    assert "constexpr int kThreads = kLines * kMaxRuns;" in src
    assert int(re.search(r"constexpr int kRun = (\d+);", src).group(1)) == RUN
    assert "constexpr int kWin = kRun + 6;" in src and WIN == RUN + 6
    assert lk.LEVEL_HALO[DD] == 3  # DD 13/7's taps reach 3 pairs beyond a run
    body = src[src.index("struct VliftArgs {") : src.index("};", src.index("struct VliftArgs {"))]
    assert re.findall(r"int (\w+);", body) == [name for name, _ in kernels.VliftArgs._fields_]
    ptrs = src[src.index("struct VliftPtrs {") : src.index("};", src.index("struct VliftPtrs {"))]
    assert "const int16_t* in[4];" in ptrs and "int16_t* out[4];" in ptrs
    assert any(p.endswith(os.path.join("csrc", "vlift.cu")) for p in kernels.SOURCES)
    assert "ako_vlift" not in _source("lift2d.cu")


@pytest.mark.parametrize("axis", AXES)
def test_wrappers_take_the_plain_version_on_the_cpu(axis):
    """On CPU tensors the wrappers are the plain versions, a pair is two
    single calls, and no launch is counted; a bad axis or length raises."""
    rng = np.random.default_rng(9)
    x0, x1 = (torch.from_numpy(rng.integers(-32768, 32768, size=(2, 9, 7)).astype(np.int16))
              for _ in range(2))
    before = dict(lk.LAUNCHES)
    pair = lk.vlift_pair(CDF, Wrap.REPEAT, x0, x1, axis)
    for x, got in zip((x0, x1), pair):
        for g, r in zip(got, wavelets.vlift(CDF, Wrap.REPEAT, x, axis)):
            assert torch.equal(g, r)
        assert all(torch.equal(g, r) for g, r in zip(got, lk.vlift_level(CDF, Wrap.REPEAT, x, axis)))
    length = x0.shape[axis]
    (lp0, hp0), (lp1, hp1) = pair
    outs = lk.vunlift_pair(CDF, Wrap.REPEAT, (lp0, hp0), (lp1, hp1), length, axis)
    for x, out in zip((x0, x1), outs):
        assert torch.equal(out, x)
        assert torch.equal(lk.vunlift_level(CDF, Wrap.REPEAT, *lk.vlift_level(CDF, Wrap.REPEAT, x,
                                                                              axis), length, axis), x)
    assert lk.LAUNCHES == before
    with pytest.raises(ValueError, match="axis"):
        lk.vlift_level(CDF, Wrap.REPEAT, x0, 0)


def test_wrappers_reject_devices_without_kernel():
    x = torch.zeros((1, 8, 8), dtype=torch.int16, device="meta")
    for axis in AXES:
        with pytest.raises(ValueError, match="no kernel"):
            lk.vlift_pair(CDF, Wrap.CLAMP, x, x, axis)
        with pytest.raises(ValueError, match="no kernel"):
            lk.vunlift_pair(CDF, Wrap.CLAMP, (x, x), (x, x), 16 if axis == -2 else 15, axis)

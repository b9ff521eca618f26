"""The region decomposition of csrc/lift_level.cu's lift_level /
unlift_level kernels, and the fused wiring's route through them, against
the plain versions and ako_tpu under JAX on the CPU.

The kernels run only on the card, so `emulate_lift` / `emulate_unlift`
repeat their arithmetic in numpy, CTA by CTA: the region origins, the
window of each (the region and its halo, clipped to the line, or for
REPEAT taken modulo the line's pairs), the fake odd sample loaded as its
even one, the lifting steps with global pair indices and the wrap rules of
tap() at the edges, the pairs each step runs on, and the stores. Every
window slot outside the CTA's load is poisoned, and every tap a step
reads must lie in the load. `emulate_forward_level` /
`emulate_inverse_level` add the fused parts: level 0's colour transform,
the q head, the gate and the multiply-high quantizer at the wire offsets,
the dequantize. Inputs come from numpy seeds; every comparison is exact
equality."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ako_tpu.core import geometry as ref_geometry
from ako_tpu.core.settings import Color as RefColor
from ako_tpu.ops import colorspace as ref_colorspace
from ako_tpu.ops import lifting as ref_lifting
from ako_tpu.ops import wavelets as ref_wavelets
from ako_tpu_torch.core import geometry
from ako_tpu_torch.core.geometry import LiftLevel
from ako_tpu_torch.core.settings import Color, Wavelet, Wrap
from ako_tpu_torch.ops import lift_kernels as lk
from ako_tpu_torch.ops import lifting, quantization, wavelets
from ako_tpu_torch.parallel import halo

PREDICT, UPDATE, UNDO_UPDATE, UNDO_PREDICT = range(4)
DD, CDF, HAAR = Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR
# pairs a step runs on beyond the range the next step finishes
# (csrc/lift_level.cu pl/pr/ul/ur)
PL, PR = {DD: 2, CDF: 1, HAAR: 0}, {DD: 1, CDF: 0, HAAR: 0}
UL, UR = {DD: 1, CDF: 0, HAAR: 0}, {DD: 2, CDF: 1, HAAR: 0}


def _w16(x):
    return ((np.asarray(x, np.int64) + 32768) & 0xFFFF) - 32768


def _div(x, s):
    """C's truncating x / 2^s in the bias-and-shift form."""
    return (x + np.where(x < 0, (1 << s) - 1, 0)) >> s


def _tap(i, d, n, wrap):
    """lift_common.cuh tap(): the pair at i + d, substituted past an end."""
    k = i + d
    if 0 <= k < n:
        return k
    if wrap == Wrap.ZERO:
        return -1
    if d == -1:
        return n - 1 if wrap == Wrap.REPEAT else 0
    if d == 1:
        return 0 if wrap == Wrap.REPEAT else n - 1
    if d == -2:
        return {Wrap.CLAMP: 0, Wrap.MIRROR: i + 1}.get(wrap, n - 2 + i)
    return {Wrap.CLAMP: n - 1, Wrap.MIRROR: i - 1}.get(wrap, i - (n - 2))


class _Axis:
    """csrc/lift_level.cu Axis: of a line of `length` samples, the
    region's pairs [r0, r1), the idx-th run of `region` pairs from p0 cut
    at p1 (the whole line by default), and the window's pairs [lo, hi)."""

    def __init__(self, length, region, idx, halo, rep, p0=0, p1=None):
        self.len, self.n, self.rep = length, (length + 1) // 2, rep
        self.r0 = p0 + idx * region
        self.r1 = min(self.r0 + region, self.n if p1 is None else p1)
        self.lo = self.r0 - halo if rep else max(self.r0 - halo, 0)
        self.hi = self.r1 + halo if rep else min(self.r1 + halo, self.n)

    def pairs(self):
        g = np.arange(self.lo, self.hi)
        return g % self.n if self.rep else g

    def samples(self):
        """The line's sample at each window slot; the fake odd sample of
        an odd line is its even one."""
        s = 2 * np.repeat(self.pairs(), 2) + np.tile([0, 1], self.hi - self.lo)
        return np.minimum(s, self.len - 1)

    def edge(self, k):
        return not self.rep and (k < 2 or k >= self.n - 2)


def _step(a, m, kind, wav, k0, k1, ax, wrap):
    """lift_step on every line of the window lines `a` (..., slots), pairs
    [k0, k1) of axis `ax` (global indices; slot 2 * (k - lo) holds pair
    k's even sample). `m` marks the loaded slots: every read must hit one."""
    if k1 <= k0 or (wav == HAAR and kind in (UPDATE, UNDO_UPDATE)):
        return
    ks = np.arange(k0, k1)
    ev = 2 * (ks - ax.lo)
    assert m[..., ev].all() and m[..., ev + 1].all(), "a step on a pair outside the load"

    def tap(d, odd):
        # an inner pair's taps are k + d, below 0 or past n in REPEAT's
        # wrapped halo; only the wrap rules give a zero tap
        g = np.array([_tap(k, d, ax.n, wrap) if ax.edge(k) else k + d for k in ks])
        zero = np.array([ax.edge(k) for k in ks]) & (g < 0)
        idx = 2 * (np.where(zero, ks, g) - ax.lo) + odd
        assert (idx >= 0).all() and m[..., idx].all(), "a tap outside the window's load"
        return np.where(zero, 0, a[..., idx])

    e, o = a[..., ev], a[..., ev + 1]
    if kind in (PREDICT, UNDO_PREDICT):
        sign = 1 if kind == PREDICT else -1
        if wav == HAAR:
            r = o - sign * e
        elif wav == CDF:
            r = o - sign * _div(e + tap(1, 0), 1)
        else:
            r = o + sign * _div(tap(-1, 0) + tap(2, 0) - 9 * (e + tap(1, 0)), 4)
        a[..., ev + 1] = _w16(r)
    else:
        if wav == CDF:
            t = _div(tap(-1, 1) + o, 2)
        else:
            t = _div(-tap(-2, 1) - tap(1, 1) + 9 * (tap(-1, 1) + o), 5)
        a[..., ev] = _w16(e + t if kind == UPDATE else e - t)


def _colour_fwd(px, color, discard):
    """lift_common.cuh colour_fwd on (..., C) u8 pixels -> (C, ...)."""
    v = px.astype(np.int64)
    C = v.shape[-1]
    if discard and C in (2, 4):
        v[..., : C - 1] = np.where(v[..., C - 1 :] == 0, 0, v[..., : C - 1])
    out = [v[..., c] for c in range(C)]
    if C >= 3 and color != Color.NONE:
        r, g, b = out[:3]
        if color == Color.SUBTRACT_G:
            out[:3] = [g, _w16(r - g), _w16(b - g)]
        else:
            co = _w16(r - b)
            tmp = _w16(b + _div(co, 1))
            cg = _w16(g - tmp)
            y = _w16(tmp + _div(cg, 1))
            out[:3] = [_w16(2 * y) if color == Color.YCOCG_Q else y, co, cg]
    return np.stack(out)


def _colour_inv(planes, color):
    """lift_common.cuh colour_inv on (C, ...) planes -> (..., C) u8."""
    v = list(planes)
    if len(v) >= 3 and color != Color.NONE:
        y, u, w = v[:3]
        if color == Color.SUBTRACT_G:
            v[:3] = [_w16(u + y), y, _w16(w + y)]
        else:
            if color == Color.YCOCG_Q:
                y = _w16(_div(y, 1))
            tmp = _w16(y - _div(w, 1))
            b = _w16(tmp - _div(u, 1))
            v[:3] = [_w16(b + u), _w16(w + tmp), b]
    return np.clip(np.stack(v, -1), 0, 255).astype(np.uint8)


def _ctas(T, th, tw, region):
    return itertools.product(range(T), range(-(-th // region[0])), range(-(-tw // region[1])))


def _load_planes(raw, planes, y, xa, w):
    """lift_level's load of a window from the (C, h, w) int16 planes into
    `raw`, the CTA's (C, rows, pitch) shared memory: with rows of a
    multiple of 8 samples (16-byte aligned), 8-sample cp.async chunks
    covering the samples on the line, the window shifted sh samples into
    its row so that each chunk lands 16-byte aligned, and the columns
    outside them (REPEAT's wrapped halo) one sample at a time; else every
    column one sample at a time. Every copy must lie inside its row and
    inside the line, no slot is written twice, and the window must hold
    the line's samples. Returns sh."""
    pitch = raw.shape[-1]
    ys, xs = y.samples(), xa.samples()
    wr, wc = len(ys), len(xs)
    vec = w % 8 == 0
    sh = (2 * xa.lo) & 7 if vec else 0
    s0, s1 = 2 * max(xa.lo, 0), min(w, 2 * min(xa.hi, xa.n))
    a0 = s0 & ~7
    nv = (s1 - a0 + 7) >> 3 if vec else 0
    i0, i1 = (s0 - 2 * xa.lo, s1 - 2 * xa.lo) if vec else (wc, wc)
    writes = np.zeros(pitch, np.int64)
    for v in range(nv):
        col, g = sh + a0 - 2 * xa.lo + 8 * v, a0 + 8 * v
        assert col % 8 == 0 and 0 <= col and col + 8 <= pitch, "a chunk outside its row"
        assert g % 8 == 0 and g + 8 <= w, "a chunk outside the line"
        raw[:, :wr, col : col + 8] = planes[:, ys, g : g + 8]
        writes[col : col + 8] += 1
    for i in [*range(i0), *range(i1, wc)]:
        raw[:, :wr, sh + i] = planes[:, ys, xs[i]]
        writes[sh + i] += 1
    assert writes.max() <= 1 and sh + wc <= pitch
    np.testing.assert_array_equal(raw[:, :wr, sh : sh + wc], planes[:, ys][:, :, xs])
    return sh


def _staged_bytes(w, C, xa, stage):
    """lift_level's staging of a u8 window row at level 0: the bytes
    [b0, b1) of the row, 16-byte copies when the row is a multiple of 16
    bytes, must cover the window's pixels on the line and fit a staging
    row of `stage` bytes."""
    row_bytes = w * C
    s0, s1 = 2 * max(xa.lo, 0), min(w, 2 * min(xa.hi, xa.n))
    vec = row_bytes % 16 == 0
    b0 = (s0 * C) & ~15 if vec else s0 * C
    b1 = min((s1 * C + 15) & ~15, row_bytes) if vec else s1 * C
    assert 0 <= b0 <= s0 * C and s1 * C <= b1 <= row_bytes and b1 - b0 <= stage
    assert not vec or (b0 % 16 == 0 and (b1 - b0) % 16 == 0)


def emulate_lift(x, h, w, wav, wrap, region, colour=None, seed=0):
    """lift_level's lift, CTA by CTA: x is the (T, C, h, w) int16 planes,
    or with `colour` = (color, discard) the (T, h, w, C) u8 tiles ->
    (ll, b, c, d), each (T, C, th, tw) int64. Each quadrant sample is
    stored by exactly one CTA."""
    rng = np.random.default_rng(seed)
    T, C = x.shape[0], x.shape[-1] if colour else x.shape[1]
    th, tw, hl, rep = (h + 1) // 2, (w + 1) // 2, lk.LEVEL_HALO[wav], wrap == Wrap.REPEAT
    pitch, plane, stage, _ = lk.level_layout(C, region, wav, colour is not None)
    quads = np.zeros((4, T, C, th, tw), np.int64)
    stores = np.zeros((T, C, th, tw), np.int64)
    for t, iy, ix in _ctas(T, th, tw, region):
        y, xa = _Axis(h, region[0], iy, hl, rep), _Axis(w, region[1], ix, hl, rep)
        raw = rng.integers(-32768, 32768, size=(C, plane // pitch, pitch))
        ys, xs = y.samples(), xa.samples()
        wr, wc = len(ys), len(xs)
        assert wr <= plane // pitch
        if colour:
            _staged_bytes(w, C, xa, stage)
            sh = 0
            raw[:, :wr, :wc] = _colour_fwd(x[t][np.ix_(ys, xs)], *colour)
        else:
            sh = _load_planes(raw, x[t], y, xa, w)
        win = raw[:, :, sh:]  # window slot i at column sh + i of its row
        m = np.zeros(win.shape, bool)
        m[:, :wr, :wc] = True
        # the window's rows, then the region's columns
        _step(win[:, :wr], m[:, :wr], PREDICT, wav, max(xa.r0 - PL[wav], xa.lo),
              min(xa.r1 + PR[wav], xa.hi), xa, wrap)
        _step(win[:, :wr], m[:, :wr], UPDATE, wav, xa.r0, xa.r1, xa, wrap)
        c0, c1 = 2 * (xa.r0 - xa.lo), 2 * (xa.r1 - xa.lo)
        cols, cm = win[:, :, c0:c1].swapaxes(1, 2), m[:, :, c0:c1].swapaxes(1, 2)
        _step(cols, cm, PREDICT, wav, max(y.r0 - PL[wav], y.lo), min(y.r1 + PR[wav], y.hi), y, wrap)
        _step(cols, cm, UPDATE, wav, y.r0, y.r1, y, wrap)
        rr, cc = 2 * (np.arange(y.r0, y.r1) - y.lo), 2 * (np.arange(xa.r0, xa.r1) - xa.lo)
        for q, (dr, dc) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):  # ll, b, c, d
            quads[q, t, :, y.r0 : y.r1, xa.r0 : xa.r1] = win[:, rr + dr][:, :, cc + dc]
        stores[t, :, y.r0 : y.r1, xa.r0 : xa.r1] += 1
    assert (stores == 1).all(), "the regions do not tile the quadrants"
    return quads


def emulate_unlift(quads, h, w, wav, wrap, region, color=None, seed=0):
    """unlift_level's unlift, CTA by CTA: (ll, b, c, d), each (T, C, th,
    tw) -> the (T, C, h, w) int16 planes, or with `color` the (T, h, w, C)
    u8 tiles after the inverse colour transform."""
    rng = np.random.default_rng(seed)
    T, C, th, tw = quads.shape[1:]
    hl, rep = lk.LEVEL_HALO[wav], wrap == Wrap.REPEAT
    pitch, plane, _, _ = lk.level_layout(C, region, wav, False)
    out = np.zeros((T, C, h, w), np.int64)
    stores = np.zeros(out.shape, np.int64)
    for t, iy, ix in _ctas(T, th, tw, region):
        y, xa = _Axis(h, region[0], iy, hl, rep), _Axis(w, region[1], ix, hl, rep)
        win = rng.integers(-32768, 32768, size=(C, plane // pitch, pitch))
        m = np.zeros(win.shape, bool)
        pr, pc = y.pairs(), xa.pairs()
        i, j = np.arange(len(pr))[:, None], np.arange(len(pc))[None, :]
        for q, (dr, dc) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
            win[:, 2 * i + dr, 2 * j + dc] = quads[q, t][:, pr][:, :, pc]
        m[:, : 2 * len(pr), : 2 * len(pc)] = True
        # every column of the window, then the region's rows
        cols, cm = win[:, :, : 2 * len(pc)].swapaxes(1, 2), m[:, :, : 2 * len(pc)].swapaxes(1, 2)
        _step(cols, cm, UNDO_UPDATE, wav, max(y.r0 - UL[wav], y.lo), min(y.r1 + UR[wav], y.hi), y,
              wrap)
        _step(cols, cm, UNDO_PREDICT, wav, y.r0, y.r1, y, wrap)
        row0, row1, col0, col1 = 2 * y.r0, min(2 * y.r1, h), 2 * xa.r0, min(2 * xa.r1, w)
        first = 2 * (y.r0 - y.lo)
        rows, rm = win[:, first : first + row1 - row0], m[:, first : first + row1 - row0]
        _step(rows, rm, UNDO_UPDATE, wav, max(xa.r0 - UL[wav], xa.lo), min(xa.r1 + UR[wav], xa.hi),
              xa, wrap)
        _step(rows, rm, UNDO_PREDICT, wav, xa.r0, xa.r1, xa, wrap)
        out[t, :, row0:row1, col0:col1] = rows[:, :, col0 - 2 * xa.lo : col1 - 2 * xa.lo]
        stores[t, :, row0:row1, col0:col1] += 1
    assert (stores == 1).all(), "the regions do not tile the plane"
    if color is None:
        return out.astype(np.int16)
    return np.stack([_colour_inv(o, color) for o in out])


def _quantize(v, q, g):
    """The gate and csrc/lift_common.cuh Divider: |v| * ceil(2^32 / q)
    >> 32 for 1 < q < 2^16."""
    qd = max(q, 1)
    if 1 < qd < 65536:
        f = (np.abs(v) * (((1 << 32) + qd - 1) // qd)) >> 32
        d = np.where(v < 0, -f, f)
    else:
        d = v if qd == 1 else np.sign(v) * (np.abs(v) // qd)
    return _w16(np.where((v < -g) | (v > g), d, 0))


def emulate_forward_level(x, stream, schedule, k, wavelet, wrap, qg, color, discard, region):
    """lift_level's launch for level k: the q heads and the gated,
    quantized C, B, D at their wire offsets of `stream` (T, coeffs), the
    LL returned (and at the last level stored at the stream's head)."""
    lvl = schedule.levels[k]
    wav = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
    ll, b, c, d = emulate_lift(x, lvl.current_h, lvl.current_w, wav, wrap, region,
                               (color, discard) if k == 0 else None, seed=k)
    T, C, th, tw = ll.shape
    n, off = th * tw, lk.level_offsets(schedule, C)[k]
    qs, gs = qg[k]
    for ch in range(C):
        base = off + ch * (1 + 3 * n)
        stream[:, base] = qs[ch]
        for j, quad in enumerate((c, b, d)):
            stream[:, base + 1 + j * n : base + 1 + (j + 1) * n] = _quantize(
                quad[:, ch], qs[ch], gs[ch]).reshape(T, n)
    if k == len(schedule.levels) - 1:
        stream[:, : ll[0].size] = ll.reshape(T, -1)
    return ll.astype(np.int16)


def emulate_inverse_level(ll, stream, schedule, k, wavelet, wrap, color, region):
    """unlift_level's launch for level k: C, B, D from their wire offsets,
    multiplied by the q head when it is above 1 (int16-wrapped)."""
    lvl = schedule.levels[k]
    wav = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
    T, C, th, tw = ll.shape
    n, off = th * tw, lk.level_offsets(schedule, C)[k]
    quads = np.zeros((4, T, C, th, tw), np.int64)
    quads[0] = ll
    for ch in range(C):
        base = off + ch * (1 + 3 * n)
        q = stream[:, base : base + 1].astype(np.int64)
        for j, slot in enumerate((2, 1, 3)):  # C, B, D
            v = stream[:, base + 1 + j * n : base + 1 + (j + 1) * n].astype(np.int64)
            quads[slot, :, ch] = _w16(np.where(q > 1, v * q, v)).reshape(T, th, tw)
    return emulate_unlift(quads, lvl.current_h, lvl.current_w, wav, wrap, region,
                          color if k == 0 else None, seed=k)


# ---------------------------------------------------------------------
# The region lift against the plain version and JAX

# (h, w) of a level's plane and the regions it is cut into: odd and even
# sides, planes narrower than a halo, thin planes of 1 and 2 rows, the
# production regions on a larger plane, and rows of a multiple of 8
# samples (the cp.async load) with REPEAT's window wider than the line
PLANES = [
    ((37, 53), ((4, 4), (8, 16))),
    ((64, 64), ((4, 4), (8, 16), (32, 64))),
    ((17, 9), ((4, 4), (8, 16))),
    ((2, 301), ((4, 4), (8, 16))),
    ((1, 40), ((4, 4), (2, 8))),
    ((150, 260), ((32, 64), (16, 64))),
    ((21, 48), ((2, 8), (4, 16))),
    ((6, 8), ((2, 8),)),
]
WAVELETS = [DD, CDF, HAAR]


def _level(h, w):
    return LiftLevel(w, h, (w + 1) // 2, (h + 1) // 2)


@pytest.mark.parametrize("wrap", list(Wrap), ids=[w.name for w in Wrap])
@pytest.mark.parametrize("wavelet", WAVELETS, ids=[w.name for w in WAVELETS])
@pytest.mark.parametrize("plane", PLANES, ids=[f"{h}x{w}" for (h, w), _ in PLANES])
def test_region_lift_matches_reference(plane, wavelet, wrap):
    """Both directions at each region size, every sample outside a CTA's
    load poisoned, against wavelets.lift2d / unlift2d and ako_tpu's XLA
    lift (the level's effective wavelet, as the kernels receive it)."""
    (h, w), regions = plane
    lvl = _level(h, w)
    wav = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
    rng = np.random.default_rng(h * 1000 + w)
    x = rng.integers(-32768, 32768, size=(1, 2, h, w)).astype(np.int16)
    quads = rng.integers(-32768, 32768, size=(4, 1, 2, lvl.target_h, lvl.target_w)).astype(np.int16)
    fwd = [q.numpy() for q in wavelets.lift2d(wav, wrap, torch.from_numpy(x), lvl)]
    inv = wavelets.unlift2d(wav, wrap, *map(torch.from_numpy, quads), lvl).numpy()
    ref_fwd = ref_wavelets.lift2d(wav, wrap, jnp.asarray(x), lvl)
    for got, ref in zip(fwd, ref_fwd):
        np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(inv, np.asarray(ref_wavelets.unlift2d(
        wav, wrap, *map(jnp.asarray, quads), lvl)))
    for region in regions:
        got = emulate_lift(x, h, w, wav, wrap, region)
        for q in range(4):
            np.testing.assert_array_equal(got[q], fwd[q], err_msg=f"region {region} quadrant {q}")
        np.testing.assert_array_equal(emulate_unlift(quads.astype(np.int64), h, w, wav, wrap, region),
                                      inv, err_msg=f"region {region} inverse")


def test_repeat_halo_wraps_to_the_far_end():
    """REPEAT's window on an edge CTA: pairs n-3 .. n-1 before the head and
    0 .. 2 after the tail, the fake odd sample kept fake where the last
    pair arrives wrapped."""
    ax = _Axis(9, 2, 0, 3, True)  # 5 pairs, the last one's odd sample fake
    np.testing.assert_array_equal(ax.pairs(), [2, 3, 4, 0, 1, 2, 3, 4])
    np.testing.assert_array_equal(ax.samples()[:6], [4, 5, 6, 7, 8, 8])
    tail = _Axis(9, 2, 2, 3, True)
    np.testing.assert_array_equal(tail.pairs(), [1, 2, 3, 4, 0, 1, 2])
    clipped = _Axis(9, 2, 2, 3, False)
    assert (clipped.lo, clipped.hi, clipped.r0, clipped.r1) == (1, 5, 4, 5)


# ---------------------------------------------------------------------
# The fused level: colour, q head, quantize/gate, wire order, dequantize

# (w, h, channels, wavelet, wrap, colour, discard, q, region): every
# colour, 1-4 and 9 channels, discard with zero alphas, q 0 / 1 / 16,
# small and production regions
FUSED = [
    (37, 53, 3, DD, Wrap.CLAMP, Color.YCOCG, False, 16, (4, 4)),
    (17, 9, 4, CDF, Wrap.REPEAT, Color.YCOCG_Q, True, 1, (4, 4)),
    (33, 17, 2, HAAR, Wrap.MIRROR, Color.SUBTRACT_G, True, 0, (8, 16)),
    (21, 13, 1, DD, Wrap.ZERO, Color.NONE, False, 16, (2, 8)),
    (40, 24, 9, DD, Wrap.REPEAT, Color.YCOCG_Q, False, 16, None),
    (64, 64, 4, DD, Wrap.MIRROR, Color.SUBTRACT_G, True, 16, (32, 64)),
    (29, 19, 4, CDF, Wrap.CLAMP, Color.NONE, True, 16, (8, 16)),
    (19, 29, 3, DD, Wrap.REPEAT, Color.YCOCG_Q, False, 1, (4, 4)),
]
FUSED_IDS = [f"{w}x{h}x{c}-{wav.name}-{wr.name}-{col.name}" for w, h, c, wav, wr, col, *_ in FUSED]
TILES = 2
H100_SMS = 132  # an H100 SXM


def _region(schedule, k, ch, wavelet, region):
    return region or lk.level_region(schedule, k, ch, wavelet, TILES, H100_SMS)


def _wrapping_streams(rng, schedule, ch, encoded):
    """Random streams of the encoded shape whose q heads are 0, 1, above
    1 (the dequantize multiply wraps) or negative."""
    noise = rng.integers(-32768, 32768, size=encoded.shape).astype(np.int16)
    for off, lvl in zip(lk.level_offsets(schedule, ch), schedule.levels):
        n = 1 + 3 * lvl.target_h * lvl.target_w
        noise[:, off : off + ch * n : n] = rng.choice([0, 1, 7, 300, -5], size=(TILES, ch))
    return noise


@pytest.mark.parametrize("case", FUSED, ids=FUSED_IDS)
def test_fused_levels_match_ako_tpu(case):
    """Every level of the tile through the emulated launches (levels 0 ..
    L-1, the LP planes stored by the last), against ako_tpu's colour
    transform + forward_tile and the plain forward_levels; then the
    emulated inverse from the LP head on the encoded streams and on
    random streams whose q heads wrap, against ako_tpu's inverse_tile +
    to_interleaved_u8 and the plain inverse_levels."""
    w, h, ch, wavelet, wrap, color, discard, q, region = case
    rng = np.random.default_rng(w * 31 + h + ch)
    tiles = rng.integers(0, 256, size=(TILES, h, w, ch)).astype(np.uint8)
    if discard:
        tiles[..., -1][rng.random((TILES, h, w)) < 0.3] = 0
    schedule = geometry.lift_schedule(w, h)
    L = len(schedule.levels)
    qg = quantization.level_qg(schedule, ch, q, 3, 2)
    ref_sched = ref_geometry.lift_schedule(w, h)
    ref = np.asarray(ref_lifting.forward_tile(
        ref_colorspace.to_planar_yuv(jnp.asarray(tiles), RefColor(color), discard), ref_sched,
        wavelet, wrap, qg, False))

    stream = np.zeros((TILES, schedule.coeff_count(ch)), np.int16)
    x = tiles
    for k in range(L):
        x = emulate_forward_level(x, stream, schedule, k, wavelet, wrap, qg, color, discard,
                                  _region(schedule, k, ch, wavelet, region))
    np.testing.assert_array_equal(stream, ref)
    plain = torch.zeros((TILES, schedule.coeff_count(ch)), dtype=torch.int16)
    lk.forward_levels(torch.from_numpy(tiles), plain, schedule, range(L), wavelet, wrap, qg, color,
                      discard)
    np.testing.assert_array_equal(plain.numpy(), ref)

    ref_inv = jax.jit(lambda c: ref_colorspace.to_interleaved_u8(
        ref_lifting.inverse_tile(c, ref_sched, wavelet, wrap, ch, False), RefColor(color), ch))
    for streams in (ref, _wrapping_streams(rng, schedule, ch, ref)):
        streams = streams.copy()
        want = np.asarray(ref_inv(jnp.asarray(streams)))
        cur = streams[:, : ch * schedule.lp_h * schedule.lp_w].reshape(
            TILES, ch, schedule.lp_h, schedule.lp_w)
        for k in reversed(range(L)):
            cur = emulate_inverse_level(cur, streams, schedule, k, wavelet, wrap, color,
                                        _region(schedule, k, ch, wavelet, region))
        np.testing.assert_array_equal(cur, want)
        c = torch.from_numpy(streams)
        got = lk.inverse_levels(lk.lp_view(c, schedule, ch), c, schedule, range(L), wavelet, wrap,
                                ch, color)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q", [2, 3, 7, 16, 48, 255, 1000, 32767, 65535, 65536, 70000])
def test_divider_is_truncating_division(q):
    """The multiply-high quantizer equals C's truncating x / q on every
    int16 value and -32768's negation."""
    v = np.arange(-32768, 32769, dtype=np.int64)
    want = _w16(np.sign(v) * (np.abs(v) // q))
    np.testing.assert_array_equal(_quantize(v, q, -1), want)


# ---------------------------------------------------------------------
# The route: forward_tiles / inverse_tiles against ako_tpu

# (w, h, channels, wavelet, wrap, colour, discard, q, pyramid_start):
# a level before a start of 1, every level through the level kernels (9
# channels, start None), and odd sides with two levels before a start of 2
ROUTE = [
    (256, 256, 3, DD, Wrap.CLAMP, Color.YCOCG_Q, False, 16, 1),
    (40, 24, 9, CDF, Wrap.REPEAT, Color.YCOCG, True, 16, None),
    (301, 257, 3, DD, Wrap.MIRROR, Color.SUBTRACT_G, False, 1, 2),
]


@pytest.mark.parametrize("case", ROUTE, ids=[f"{w}x{h}x{c}" for w, h, c, *_ in ROUTE])
def test_route_matches_ako_tpu(case):
    """The fused wiring at its pyramid_start (the plain versions on the
    CPU; no kernel launch counted) against ako_tpu, on the encoded
    streams and random streams whose q heads wrap."""
    w, h, ch, wavelet, wrap, color, discard, q, start = case
    schedule = geometry.lift_schedule(w, h)
    assert lk.pyramid_start(schedule, ch) == start
    rng = np.random.default_rng(w + h + ch)
    tiles = rng.integers(0, 256, size=(TILES, h, w, ch)).astype(np.uint8)
    if discard:
        tiles[..., -1][rng.random((TILES, h, w)) < 0.3] = 0
    qg = quantization.level_qg(schedule, ch, q, 2, 1)
    ref_sched = ref_geometry.lift_schedule(w, h)
    ref = np.asarray(jax.jit(lambda t: ref_lifting.forward_tile(
        ref_colorspace.to_planar_yuv(t, RefColor(color), discard), ref_sched, wavelet, wrap, qg,
        False))(jnp.asarray(tiles)))
    before = dict(lk.LAUNCHES)
    got = lifting.forward_tiles(torch.from_numpy(tiles), schedule, wavelet, wrap, qg, color, discard)
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_inv = jax.jit(lambda c: ref_colorspace.to_interleaved_u8(
        ref_lifting.inverse_tile(c, ref_sched, wavelet, wrap, ch, False), RefColor(color), ch))
    for streams in (ref.copy(), _wrapping_streams(rng, schedule, ch, ref)):
        pix = lifting.inverse_tiles(torch.from_numpy(streams), schedule, wavelet, wrap, ch, color)
        np.testing.assert_array_equal(pix.numpy(), np.asarray(ref_inv(jnp.asarray(streams))))
    assert lk.LAUNCHES == before


# ---------------------------------------------------------------------
# Shapes, tables and the wrappers


def test_level_regions_of_the_whole_tile():
    """The default whole 1024x1280 (w x h) RGBA tile's levels before its
    pyramid start on an H100 SXM: 16x64 regions at level 0 (320 CTAs:
    32x64 would give 160, one to two an SM) and level 1 (80 CTAs), 8x32 at
    level 2; on a card of 200 SMs level 0 would take 32x64 (160 CTAs, at
    most one an SM)."""
    schedule = geometry.lift_schedule(1024, 1280)
    got = []
    for k in range(lk.pyramid_start(schedule, 4)):
        lvl = schedule.levels[k]
        region = lk.level_region(schedule, k, 4, DD, 1, H100_SMS)
        ctas = -(-lvl.target_h // region[0]) * -(-lvl.target_w // region[1])
        got.append((region, ctas))
        assert lk.level_layout(4, region, DD, True)[3] <= lk.LEVEL_SMEM_BYTES
    assert got == [((16, 64), 320), ((16, 64), 80), ((8, 32), 80)]
    assert lk.level_region(schedule, 0, 4, DD, 1, 200) == (32, 64)
    # 16x64 samples with DD 13/7's 3-pair halos: 44 rows of 140 samples in
    # a 152-sample pitch, two 592-byte staging rows a warp
    assert lk.level_layout(4, (16, 64), DD, True) == (152, 44 * 152, 592,
                                                      2 * 4 * 44 * 152 + 2 * 16 * 592)
    # 16 channels still fit a region
    assert lk.level_region(schedule, 0, 16, DD, 1, H100_SMS) in lk.LEVEL_REGIONS
    with pytest.raises(ValueError):
        lk.level_region(schedule, 0, 17, DD, 1, H100_SMS)


@pytest.mark.parametrize("wavelet", WAVELETS, ids=[w.name for w in WAVELETS])
def test_level_layout_passes_the_kernel_check(wavelet):
    """For every region, 1-16 channels and both directions, the layout that
    level_layout gives passes csrc/lift_level.cu level_grid's check (its
    buffers inside the launch's bytes, pitch and plane multiples of 8
    samples, staging rows of 16 bytes) whenever it fits a block, and holds
    the window and its 16-byte copies' shift."""
    import os

    from ako_tpu_torch.runtime import kernels

    src = open(os.path.join(os.path.dirname(kernels.__file__), "..", "csrc", "lift_level.cu")).read()
    assert ("const long long used = 2LL * a.channels * a.plane + (stage ? 2LL * kWarps * a.stage : 0);"
            in src)
    assert "(a.pitch | a.plane) % 8 || (stage && a.stage % 16) || used > a.smem" in src
    limit = 232448  # kMaxSmem
    taken = 0
    for region, ch, stage in itertools.product(lk.LEVEL_REGIONS, range(1, 17), (False, True)):
        pitch, plane, row_stage, smem = lk.level_layout(ch, region, wavelet, stage)
        cols = 2 * (region[1] + 2 * lk.LEVEL_HALO[wavelet])
        assert pitch % 8 == 0 and plane % 8 == 0 and row_stage % 16 == 0
        assert pitch >= cols + 6 and plane == 2 * (region[0] + 2 * lk.LEVEL_HALO[wavelet]) * pitch
        assert row_stage >= cols * ch + 30
        assert 2 * ch * plane + (2 * lk._LEVEL_WARPS * row_stage if stage else 0) <= smem
        taken += smem <= limit
    assert taken


def test_level_args_table():
    """The kernels' table for level 1 of a 3-channel 256-px tile: the
    plane, the region, the effective wavelet, the chunk offset and q/g."""
    schedule = geometry.lift_schedule(256, 256)
    qg = quantization.level_qg(schedule, 3, 16, 2, 1)
    a = lk._level_args(schedule, 1, 3, DD, Wrap.MIRROR, tuple(qg), Color.YCOCG_Q, True,
                       3 * 64 * 64, (8, 16))
    assert (a.channels, a.height, a.width, a.rh, a.rw, a.u8) == (3, 128, 128, 8, 16, 0)
    assert (a.wavelet, a.wrap, a.color, a.discard) == (DD, Wrap.MIRROR, Color.YCOCG_Q, 1)
    assert (a.coeffs, a.off, a.ll_stride) == (schedule.coeff_count(3),
                                               lk.level_offsets(schedule, 3)[1], 3 * 64 * 64)
    assert tuple(a.q[:3]) == qg[1][0] and tuple(a.g[:3]) == qg[1][1]
    # 8x16 samples with 3-pair halos: 28 rows of 44 samples in a 56-sample
    # pitch; no staging past level 0
    assert (a.pitch, a.plane, a.stage, a.smem) == (56, 28 * 56, 176, 2 * 3 * 28 * 56)


def test_level_wrappers_reject_devices_without_kernel():
    schedule = geometry.lift_schedule(16, 16)
    tiles = torch.zeros((1, 16, 16, 3), dtype=torch.uint8, device="meta")
    stream = torch.zeros((1, schedule.coeff_count(3)), dtype=torch.int16, device="meta")
    qg = [((1, 1, 1), (0, 0, 0))] * len(schedule.levels)
    with pytest.raises(ValueError, match="no kernel"):
        lk.forward_levels(tiles, stream, schedule, range(1), DD, Wrap.CLAMP, qg, Color.YCOCG_Q,
                          False)
    with pytest.raises(ValueError, match="no kernel"):
        lk.inverse_levels(lk.lp_view(stream, schedule, 3), stream, schedule, range(1), DD,
                          Wrap.CLAMP, 3, Color.YCOCG_Q)
    with pytest.raises(ValueError, match="not a run"):
        lk.forward_levels(tiles, stream, schedule, range(0), DD, Wrap.CLAMP, qg, Color.YCOCG_Q,
                          False)


def test_kernel_constants_match_source():
    """LEVEL_HALO, the warps and the table's fields are csrc/lift_level.cu's."""
    import os
    import re

    from ako_tpu_torch.runtime import kernels

    src = open(os.path.join(os.path.dirname(kernels.__file__), "..", "csrc", "lift_level.cu")).read()
    assert "return wav == DD137 ? 3 : wav == CDF53 ? 1 : 0;" in src
    assert lk.LEVEL_HALO == {DD: 3, CDF: 1, HAAR: 0}
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) // 32 == lk._LEVEL_WARPS
    body = src[src.index("struct LevelArgs {") : src.index("};", src.index("struct LevelArgs {"))]
    fields = re.findall(r"int (\w+)(?:\[kLevelChannels\])?;", body)
    assert fields == [name for name, _ in kernels.LevelArgs._fields_]
    assert int(re.search(r"kLevelChannels = (\d+);", src).group(1)) == kernels.MAX_LEVEL_CHANNELS


# ---------------------------------------------------------------------
# K7: the shard-table instances (lift_level_shards / unlift_level_shards)
# on a device's shards of a level, rows read in place from segments; the
# one-shard case on a window buffer (lift_level_rows / unlift_level_rows);
# and the sharded lift of parallel/halo.py through them

POISON = 11  # poisoned elements before, between and after a segment's rows


def _flat(t):
    """The whole storage under a CPU tensor view, as a flat int16 array."""
    return torch.empty(0, dtype=t.dtype).set_(t.untyped_storage()).numpy()


def _seg_row(segs, ch, r, q=0):
    """csrc/lift_level.cu seg_of + seg_row: channel ch's row (pair) r, and
    for a C, B, D segment its quadrant q, in the first segment that holds
    it, as (flat storage, element offset); a row no segment holds would
    be read from the last segment's poison."""
    for s in segs:
        t = s.t
        if s.lo <= r < s.lo + t.shape[-2]:
            off = (t.storage_offset() + ch * t.stride(0) + (q * t.stride(1) if t.dim() == 4 else 0)
                   + (r - s.lo) * t.stride(-2))
            return _flat(t), off
    raise AssertionError(f"row {r}: no segment holds it")


def _shard_ctas(shards, rh, nx):
    """csrc/lift_level.cu shard_grid's prefix counts and region()'s scan:
    each CTA's shard and its index among the shard's CTAs."""
    cta0 = [0]
    for p0, p1 in shards:
        cta0.append(cta0[-1] + -(-(p1 - p0) // rh) * nx)
    for b in range(cta0[-1]):
        i = 0
        while i + 1 < len(shards) and cta0[i + 1] <= b:
            i += 1
        yield shards[i], b - cta0[i]


def _load_rows(raw, rows, aligned, xa, w):
    """lift_body's SHARDS load: _load_planes on rows read from segments,
    (C, wr, w), a row's 16-byte chunks only where its segment's row is
    16-byte aligned (`aligned`, (C, wr)) and w a multiple of 8, else every
    column one sample at a time. Every copy inside its row and the line, no
    slot written twice. Returns sh."""
    pitch = raw.shape[-1]
    C, wr, _ = rows.shape
    xs = xa.samples()
    wc, vec = len(xs), w % 8 == 0
    sh = (2 * xa.lo) & 7 if vec else 0
    s0, s1 = 2 * max(xa.lo, 0), min(w, 2 * min(xa.hi, xa.n))
    a0 = s0 & ~7
    writes = np.zeros((C, wr, pitch), np.int64)
    for ch, j in itertools.product(range(C), range(wr)):
        rv = vec and aligned[ch, j]
        nv = (s1 - a0 + 7) >> 3 if rv else 0
        i0, i1 = (s0 - 2 * xa.lo, s1 - 2 * xa.lo) if rv else (wc, wc)
        for v in range(nv):
            col, g = sh + a0 - 2 * xa.lo + 8 * v, a0 + 8 * v
            assert col % 8 == 0 and 0 <= col and col + 8 <= pitch, "a chunk outside its row"
            assert g % 8 == 0 and g + 8 <= w, "a chunk outside the line"
            raw[ch, j, col : col + 8] = rows[ch, j, g : g + 8]
            writes[ch, j, col : col + 8] += 1
        for i in [*range(i0), *range(i1, wc)]:
            raw[ch, j, sh + i] = rows[ch, j, xs[i]]
            writes[ch, j, sh + i] += 1
    assert writes.max() <= 1 and sh + wc <= pitch
    np.testing.assert_array_equal(raw[:, :wr, sh : sh + wc], rows[:, :, xs])
    return sh


def emulate_lift_shards(segs, shards, ll, chunk, out_p0, h, w, wav, wrap, region, q, g, seed=0):
    """lift_level_shards's launch, CTA by CTA: each CTA's shard from the
    prefix counts, its window's plane rows (y.sample on the global pair)
    read from the segments (poisoned outside them), the steps with global
    pair indices, and the stores into ll, (C, out_len, tw), and chunk, (C,
    1 + 3 out_len tw), numpy copies of the outputs (poisoned), in place:
    LL, the gated, quantized C, B, D, and the q heads by the region at
    pair out_p0's first column. Every output sample is stored at most
    once; returns the count of stores per quadrant sample and of head
    stores."""
    rng = np.random.default_rng(seed)
    C, out_len, tw = ll.shape
    hl, rep = lk.LEVEL_HALO[wav], wrap == Wrap.REPEAT
    pitch, plane, _, _ = lk.level_layout(C, region, wav, False)
    nx = -(-tw // region[1])
    n = out_len * tw
    stores = np.zeros((C, out_len, tw), np.int64)
    heads = 0
    for (p0, p1), local in _shard_ctas(shards, region[0], nx):
        y = _Axis(h, region[0], local // nx, hl, rep, p0, p1)
        xa = _Axis(w, region[1], local % nx, hl, rep)
        raw = rng.integers(-32768, 32768, size=(C, plane // pitch, pitch))
        ys = y.samples()
        rows = np.zeros((C, len(ys), w), np.int64)
        aligned = np.zeros((C, len(ys)), bool)
        for ch, j in itertools.product(range(C), range(len(ys))):
            flat, off = _seg_row(segs, ch, ys[j])
            rows[ch, j], aligned[ch, j] = flat[off : off + w], off % 8 == 0
        sh = _load_rows(raw, rows, aligned, xa, w)
        win_s = raw[:, :, sh:]
        wr, wc = len(ys), len(xa.samples())
        m = np.zeros(win_s.shape, bool)
        m[:, :wr, :wc] = True
        _step(win_s[:, :wr], m[:, :wr], PREDICT, wav, max(xa.r0 - PL[wav], xa.lo),
              min(xa.r1 + PR[wav], xa.hi), xa, wrap)
        _step(win_s[:, :wr], m[:, :wr], UPDATE, wav, xa.r0, xa.r1, xa, wrap)
        c0, c1 = 2 * (xa.r0 - xa.lo), 2 * (xa.r1 - xa.lo)
        cols, cm = win_s[:, :, c0:c1].swapaxes(1, 2), m[:, :, c0:c1].swapaxes(1, 2)
        _step(cols, cm, PREDICT, wav, max(y.r0 - PL[wav], y.lo), min(y.r1 + PR[wav], y.hi), y, wrap)
        _step(cols, cm, UPDATE, wav, y.r0, y.r1, y, wrap)
        if local == 0 and y.r0 == out_p0:
            chunk[:, 0] = np.asarray(q)
            heads += 1
        rr, cc = 2 * (np.arange(y.r0, y.r1) - y.lo), 2 * (np.arange(xa.r0, xa.r1) - xa.lo)
        o = slice(y.r0 - out_p0, y.r1 - out_p0)
        ll[:, o, xa.r0 : xa.r1] = win_s[:, rr][:, :, cc]
        for j, (dr, dc) in enumerate(((1, 0), (0, 1), (1, 1))):  # C, B, D
            v = win_s[:, rr + dr][:, :, cc + dc]
            quad = chunk[:, 1 + j * n : 1 + (j + 1) * n].reshape(C, out_len, tw)
            for ch in range(C):
                quad[ch, o, xa.r0 : xa.r1] = _quantize(v[ch], q[ch], g[ch])
        stores[:, o, xa.r0 : xa.r1] += 1
    assert stores.max() <= 1, "an output stored twice"
    return stores, heads


def emulate_unlift_shards(ll_segs, cbd_segs, heads, shards, out, out_p0, h, w, wav, wrap, region,
                          seed=0):
    """unlift_level_shards's launch, CTA by CTA: each window pair's LL and
    C, B, D rows (the global pair, REPEAT's modulo) read from the segments
    (poisoned outside them), C, B, D dequantized by the q heads as they
    load, the steps, and the plane's rows stored into out, (C, out_len,
    w), rows from 2 out_p0, a numpy copy of the output (poisoned), in
    place. Returns the count of stores per output sample (at most 1)."""
    rng = np.random.default_rng(seed)
    C, out_len = out.shape[:2]
    tw = (w + 1) // 2
    hl, rep = lk.LEVEL_HALO[wav], wrap == Wrap.REPEAT
    pitch, plane, _, _ = lk.level_layout(C, region, wav, False)
    nx = -(-tw // region[1])
    stores = np.zeros(out.shape, np.int64)
    for (p0, p1), local in _shard_ctas(shards, region[0], nx):
        y = _Axis(h, region[0], local // nx, hl, rep, p0, p1)
        xa = _Axis(w, region[1], local % nx, hl, rep)
        win_s = rng.integers(-32768, 32768, size=(C, plane // pitch, pitch))
        m = np.zeros(win_s.shape, bool)
        pr, pc = y.pairs(), xa.pairs()
        for ch, i in itertools.product(range(C), range(len(pr))):
            flat, off = _seg_row(ll_segs, ch, pr[i])
            win_s[ch, 2 * i, 0 : 2 * len(pc) : 2] = flat[off + pc]
            qh = int(heads[ch])
            for q, (dr, dc) in enumerate(((1, 0), (0, 1), (1, 1))):  # C, B, D
                flat, off = _seg_row(cbd_segs, ch, pr[i], q)
                v = flat[off + pc].astype(np.int64)
                win_s[ch, 2 * i + dr, dc : 2 * len(pc) : 2] = _w16(v * qh) if qh > 1 else v
        m[:, : 2 * len(pr), : 2 * len(pc)] = True
        cols, cm = win_s[:, :, : 2 * len(pc)].swapaxes(1, 2), m[:, :, : 2 * len(pc)].swapaxes(1, 2)
        _step(cols, cm, UNDO_UPDATE, wav, max(y.r0 - UL[wav], y.lo), min(y.r1 + UR[wav], y.hi), y,
              wrap)
        _step(cols, cm, UNDO_PREDICT, wav, y.r0, y.r1, y, wrap)
        row0, row1, col0, col1 = 2 * y.r0, min(2 * y.r1, h), 2 * xa.r0, min(2 * xa.r1, w)
        first = 2 * (y.r0 - y.lo)
        rw, rm = win_s[:, first : first + row1 - row0], m[:, first : first + row1 - row0]
        _step(rw, rm, UNDO_UPDATE, wav, max(xa.r0 - UL[wav], xa.lo), min(xa.r1 + UR[wav], xa.hi),
              xa, wrap)
        _step(rw, rm, UNDO_PREDICT, wav, xa.r0, xa.r1, xa, wrap)
        o = slice(row0 - 2 * out_p0, row1 - 2 * out_p0)
        out[:, o, col0:col1] = rw[:, :, col0 - 2 * xa.lo : col1 - 2 * xa.lo]
        stores[:, o, col0:col1] += 1
    assert stores.max() <= 1, "an output stored twice"
    return stores


def _segments(rng, x, runs, pitch_pad=(0, 3, 8)):
    """Segments of the rows `runs` ([a, b) along dim -2) of x, each in a
    buffer of its own: POISON random elements before it, its rows at a
    pitch of the row and 0, 3 or 8 more samples, channels (and
    quadrants) apart by more poison, an element offset that leaves some
    rows unaligned for 16-byte copies."""
    segs = []
    for a, b in runs:
        part = x[..., a:b, :]
        *outer, rows, width = part.shape
        pitch = width + int(rng.choice(pitch_pad))
        strides, size = [pitch, 1], rows * pitch + POISON
        for d in reversed(outer):
            strides.insert(0, size)
            size = size * d + POISON
        off = POISON + int(rng.integers(0, 3))
        buf = rng.integers(-32768, 32768, size=off + size + POISON).astype(np.int16)
        view = np.lib.stride_tricks.as_strided(buf[off:], part.shape, [2 * s for s in strides])
        view[...] = part
        t = torch.from_numpy(buf).as_strided(part.shape, strides, off)
        segs.append(lk.Segment(a, t))
    return segs


def _cuts(rng, n, parts):
    """[0, n) cut at random into at most `parts` runs."""
    cuts = sorted({0, n, *rng.integers(1, max(n, 2), size=parts - 1).tolist()})
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if a < b]


def _launches(T, n_shards):
    """Launch tables of a level: every shard in one launch (one device),
    alternate shards in two (two devices), and each shard alone."""
    pairs = [p for p in halo.shard_pairs(T, n_shards) if p[0] < p[1]]
    return [pairs, pairs[0::2], pairs[1::2]] + [[p] for p in pairs]


# (h, w, shards, channels) of a level: T = 25 over 8 (a one-pair and an
# empty shard), an odd height over 3 (ragged), a small level where DD
# 13/7 falls back to CDF 5/3 over 2, an odd height over 8 with rows of a
# multiple of 8 samples (the 16-byte copies)
SHARD_LEVELS = [(50, 20, 8, 2), (37, 24, 3, 2), (13, 40, 2, 1), (51, 16, 8, 2)]


@pytest.mark.parametrize("wrap", list(Wrap), ids=[w.name for w in Wrap])
@pytest.mark.parametrize("wavelet", WAVELETS, ids=[w.name for w in WAVELETS])
def test_shards_launch_matches_plain_and_ako_tpu(wavelet, wrap):
    """lift_level_shards / unlift_level_shards emulated CTA by CTA on
    launches of every shard at once, of alternate shards and of each
    shard alone, their sources split at random into segments in buffers
    of their own, poisoned outside them, some rows unaligned; the
    outputs, poisoned before, equal to the plain versions' (which assemble
    each shard's window by indexing) everywhere, and on the launch's pairs
    to ako_tpu's lift2d / unlift2d and _quantize_gate on the whole level.
    The one-shard launch on a window buffer (lift_level_rows's
    window_segments) too; an empty shard and a table that misses a
    window's row are refused."""
    for h, w, n_sh, C in SHARD_LEVELS:
        lvl = _level(h, w)
        T, tw = lvl.target_h, lvl.target_w
        schedule = geometry.LiftSchedule(w, h, (lvl,))
        wav = wavelets.effective_wavelet(wavelet, tw, T)
        region_of = lambda shards: lk.shards_region(schedule, 0, C, wavelet, tuple(shards), H100_SMS)
        rng = np.random.default_rng(h * w + int(wavelet) * 4 + int(wrap))
        planes = rng.integers(-32768, 32768, size=(C, h, w)).astype(np.int16)
        qs = tuple(int(v) for v in rng.choice([0, 1, 7, 16], C))
        qg = ((qs, (2,) * C),)
        q, g = np.asarray(qs).reshape(C, 1, 1), np.full((C, 1, 1), 2)
        ref = [np.asarray(x) for x in ref_wavelets.lift2d(wav, wrap, jnp.asarray(planes), lvl)]
        cbd_ref = [_quantize_ref(x, q, g) for x in (ref[2], ref[1], ref[3])]  # C, B, D
        ll_in = rng.integers(-32768, 32768, size=(C, T, tw)).astype(np.int16)
        cbd_in = rng.integers(-32768, 32768, size=(C, 3, T, tw)).astype(np.int16)
        heads = rng.choice([0, 1, 7, 300, -5], C).astype(np.int16)
        deq = np.where(heads.reshape(C, 1, 1, 1) > 1,
                       (cbd_in.astype(np.int64) * heads.reshape(C, 1, 1, 1)).astype(np.int16), cbd_in)
        rec = np.asarray(ref_wavelets.unlift2d(wav, wrap, jnp.asarray(ll_in), jnp.asarray(deq[:, 1]),
                                               jnp.asarray(deq[:, 0]), jnp.asarray(deq[:, 2]), lvl))
        fwd_segs = _segments(rng, planes, _cuts(rng, h, 4))
        ll_segs = _segments(rng, ll_in, _cuts(rng, T, 3))
        cbd_segs = _segments(rng, cbd_in, _cuts(rng, T, 3))
        hd = torch.from_numpy(heads)
        for shards in _launches(T, n_sh):
            region = region_of(shards)
            one = len(shards) == 1
            out_p0, out_len = (shards[0][0], shards[0][1] - shards[0][0]) if one else (0, T)
            segs, lls, cbds = fwd_segs, ll_segs, cbd_segs
            if one:  # lift_level_rows's case: a window buffer, two poisoned pairs around
                win_lo, win_n = lk.row_window(T, shards[0], wav, wrap)
                rows = lk.window_rows(win_lo, win_n, lvl, wrap)
                pairs = lk.window_pairs(win_lo, win_n, T, wrap)

                def buffer(x, per_pair):
                    pad = [rng.integers(-32768, 32768, size=(*x.shape[:-2], 2 * per_pair,
                                                             x.shape[-1])) for _ in range(2)]
                    full = np.concatenate([pad[0], x, pad[1]], axis=-2).astype(np.int16)
                    return _segments(rng, full, [(0, full.shape[-2])])[0].t

                window = (buffer(planes[:, rows], 2), buffer(ll_in[:, pairs], 1),
                          buffer(cbd_in[:, :, pairs], 1))
                segs, lls, cbds = (lk.window_segments(b, win_lo - 2, lvl, shards[0], wav, wrap, pp)
                                   for b, pp in zip(window, (2, 1, 1)))
                assert len(segs) == (1 if wrap != Wrap.REPEAT else len(lk.pair_runs(
                    win_lo, win_lo + win_n, T, wrap)))
            # forward: outputs poisoned, the emulation against the plain version
            ll0 = rng.integers(-32768, 32768, size=(C, out_len, tw)).astype(np.int16)
            ch0 = rng.integers(-32768, 32768, size=C * (1 + 3 * out_len * tw)).astype(np.int16)
            ll_e, ch_e = ll0.astype(np.int64), ch0.astype(np.int64).reshape(C, -1)
            stores, nheads = emulate_lift_shards(segs, shards, ll_e, ch_e, out_p0, h, w, wav, wrap,
                                                 region, qs, (2,) * C)
            ll_p, ch_p = torch.from_numpy(ll0.copy()), torch.from_numpy(ch0.copy())
            lk.lift_level_shards(segs, schedule, 0, shards, ll_p, ch_p, out_p0, wavelet, wrap, qg)
            np.testing.assert_array_equal(ll_e, ll_p.numpy())
            np.testing.assert_array_equal(ch_e.reshape(-1), ch_p.numpy())
            mine = np.zeros(out_len, bool)
            for p0, p1 in shards:
                mine[p0 - out_p0 : p1 - out_p0] = True
            assert (stores[:, mine] == 1).all() and not stores[:, ~mine].any()
            assert nheads == (shards[0][0] == out_p0)
            sel = np.flatnonzero(mine) + out_p0
            np.testing.assert_array_equal(ll_e[:, mine], ref[0][:, sel])
            quads = ch_e[:, 1:].reshape(C, 3, out_len, tw)
            for j in range(3):
                np.testing.assert_array_equal(quads[:, j][:, mine], cbd_ref[j][:, sel])
            # inverse
            o_rows = min(2 * (out_p0 + out_len), h) - 2 * out_p0
            out0 = rng.integers(-32768, 32768, size=(C, o_rows, w)).astype(np.int16)
            out_e = out0.astype(np.int64)
            stores = emulate_unlift_shards(lls, cbds, heads, shards, out_e, out_p0, h, w, wav, wrap,
                                           region)
            out_p = torch.from_numpy(out0.copy())
            lk.unlift_level_shards(lls, cbds, hd, schedule, 0, shards, out_p, out_p0, wavelet, wrap)
            np.testing.assert_array_equal(out_e, out_p.numpy())
            rmine = np.zeros(o_rows, bool)
            for p0, p1 in shards:
                rmine[2 * (p0 - out_p0) : min(2 * p1, h) - 2 * out_p0] = True
            assert (stores[:, rmine] == 1).all() and not stores[:, ~rmine].any()
            np.testing.assert_array_equal(out_e[:, rmine], rec[:, np.flatnonzero(rmine) + 2 * out_p0])
        # an empty shard, and segments that miss a window's row, are refused
        ll_p = torch.zeros((C, T, tw), dtype=torch.int16)
        ch_p = torch.zeros(C * (1 + 3 * T * tw), dtype=torch.int16)
        with pytest.raises(ValueError, match="non-empty"):
            lk.lift_level_shards(fwd_segs, schedule, 0, [(0, 1), (1, 1)], ll_p, ch_p, 0, wavelet,
                                 wrap, qg)
        with pytest.raises(ValueError, match="do not hold"):
            lk.lift_level_shards(fwd_segs[1:], schedule, 0, [(0, T)], ll_p, ch_p, 0, wavelet, wrap,
                                 qg)


def _quantize_ref(x, q, g):
    return np.asarray(ref_lifting._quantize_gate(jnp.asarray(x), jnp.asarray(q), jnp.asarray(g)))


def test_shards_table_limits():
    """A launch takes 1 to MAX_SHARDS shards and at most MAX_SEGS
    segments, refused with a ValueError before any launch; the constants
    and the tables' fields are csrc/lift_level.cu's."""
    import ctypes
    import os
    import re

    from ako_tpu_torch.runtime import kernels

    lvl = _level(600, 8)
    schedule = geometry.LiftSchedule(8, 600, (lvl,))
    qg = (((1,), (0,)),)
    plane = torch.zeros((1, 600, 8), dtype=torch.int16)
    ll = torch.zeros((1, 300, 4), dtype=torch.int16)
    chunk = torch.zeros(1 + 3 * 300 * 4, dtype=torch.int16)
    shards = [(8 * i, 8 * i + 8) for i in range(kernels.MAX_SHARDS + 1)]
    with pytest.raises(ValueError, match="1 to 32"):
        lk.lift_level_shards([lk.Segment(0, plane[0:1])], schedule, 0, shards, ll, chunk, 0,
                             DD, Wrap.CLAMP, qg)
    segs = [lk.Segment(r, plane[:, r : r + 1]) for r in range(kernels.MAX_SEGS + 1)]
    with pytest.raises(ValueError, match="1 to 64"):
        lk.lift_level_shards(segs, schedule, 0, [(0, 4)], ll, chunk, 0, DD, Wrap.CLAMP, qg)
    src = open(os.path.join(os.path.dirname(kernels.__file__), "..", "csrc", "lift_level.cu")).read()
    assert int(re.search(r"kMaxShards = (\d+);", src).group(1)) == kernels.MAX_SHARDS
    assert int(re.search(r"kMaxSegs = (\d+);", src).group(1)) == kernels.MAX_SEGS
    for struct, cls in (("Seg", kernels.Seg), ("ShardArgs", kernels.ShardArgs)):
        body = src[src.index(f"struct {struct} {{") : src.index("};", src.index(f"struct {struct} {{"))]
        fields = re.findall(r"(\w+)(?:\[[^]]*\])?;", body)
        assert fields == [name for name, _ in cls._fields_]
    # a kernel's parameters: at most 4 KB
    assert ctypes.sizeof(kernels.ShardArgs) + ctypes.sizeof(kernels.LevelArgs) + 16 <= 4096


def test_shards_region_of_the_whole_tile():
    """A launch over all 8 shards of the whole tile's levels takes the
    whole level's region, as lift_level does: 16x64 and 320 CTAs at level
    0; a launch over alternate shards (two devices) the region for its own
    CTAs (32x64: 96)."""
    schedule = geometry.lift_schedule(1024, 1280)
    for k in range(2):
        T = schedule.levels[k].target_h
        pairs = tuple(halo.shard_pairs(T, 8))
        assert (lk.shards_region(schedule, k, 4, DD, pairs, H100_SMS)
                == lk.level_region(schedule, k, 4, DD, 1, H100_SMS) == (16, 64))
    pairs = tuple(halo.shard_pairs(640, 8))
    assert sum(-(-(p1 - p0) // 16) * 8 for p0, p1 in pairs) == 320
    # alternate shards: 32x64 gives 96 CTAs, one an SM at most
    assert lk.shards_region(schedule, 0, 4, DD, pairs[0::2], H100_SMS) == (32, 64)


def _emulated_shard_kernels(launches):
    """Stand-ins for lk.lift_level_shards / unlift_level_shards that run
    the emulations on copies of the outputs, at the region the wrappers
    pick on an H100 SXM, check each launch against the plain version
    (every output element, poison included), and write the results back
    as the kernel would. `launches` collects (kind, level, shards, head
    stores)."""

    def lift(segs, schedule, k, shards, ll, chunk, out_p0, wavelet, wrap, qg):
        lvl = schedule.levels[k]
        C = ll.shape[0]
        wav = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        region = lk.shards_region(schedule, k, C, wavelet, tuple(shards), H100_SMS)
        ll_e, ch_e = ll.numpy().astype(np.int64), chunk.numpy().astype(np.int64).reshape(C, -1)
        qs, gs = qg[k]
        _, nheads = emulate_lift_shards(segs, shards, ll_e, ch_e, out_p0, lvl.current_h,
                                        lvl.current_w, wav, wrap, region, qs, gs, seed=k)
        lk.lift_level_shards_plain(segs, schedule, k, shards, ll, chunk, out_p0, wavelet, wrap, qg)
        np.testing.assert_array_equal(ll_e, ll.numpy())
        np.testing.assert_array_equal(ch_e.reshape(-1), chunk.numpy())
        launches.append(("fwd", k, tuple(shards), nheads))

    def unlift(ll_segs, cbd_segs, heads, schedule, k, shards, out, out_p0, wavelet, wrap):
        lvl = schedule.levels[k]
        wav = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        region = lk.shards_region(schedule, k, out.shape[0], wavelet, tuple(shards), H100_SMS)
        out_e = out.numpy().astype(np.int64)
        emulate_unlift_shards(ll_segs, cbd_segs, heads.numpy(), shards, out_e, out_p0,
                              lvl.current_h, lvl.current_w, wav, wrap, region, seed=k)
        lk.unlift_level_shards_plain(ll_segs, cbd_segs, heads, schedule, k, shards, out, out_p0,
                                     wavelet, wrap)
        np.testing.assert_array_equal(out_e, out.numpy())
        launches.append(("inv", k, tuple(shards), 0))

    return lift, unlift


# (w, h, shards, channels, wavelet, wrap, devices): the trouble shapes at
# narrow widths (raggedness is in the rows): the whole north-star tile's
# 1280 rows over 3 shards (every level ragged), the tractor's 2464 over 8
# (ragged from level 2, odd sides at level 5), T = 25 over 8 (a one-pair
# and an empty shard), odd and ragged sides, REPEAT and MIRROR at both
# ends; on one device (a launch a level), and on two whose shards
# alternate (a launch a device and level, the halo rows copied between
# them)
ROWS_CASES = [
    (40, 1280, 3, 1, DD, Wrap.MIRROR, 1),
    (24, 2464, 8, 1, DD, Wrap.REPEAT, 1),
    (20, 50, 8, 2, DD, Wrap.REPEAT, 1),
    (20, 50, 8, 2, CDF, Wrap.MIRROR, 1),
    (127, 127, 8, 2, CDF, Wrap.REPEAT, 1),
    (96, 100, 8, 2, DD, Wrap.ZERO, 1),
    (77, 93, 8, 1, DD, Wrap.CLAMP, 1),
    (96, 100, 8, 2, HAAR, Wrap.REPEAT, 1),
    (20, 50, 8, 2, DD, Wrap.REPEAT, 2),
    (77, 93, 8, 1, CDF, Wrap.MIRROR, 2),
    (40, 1280, 3, 1, DD, Wrap.CLAMP, 2),
]


@pytest.mark.parametrize("case", ROWS_CASES, ids=[f"{w}x{h}-{n}sh-{wv.name}-{wr.name}-{d}dev"
                                                  for w, h, n, _, wv, wr, d in ROWS_CASES])
def test_rows_kernels_through_the_sharded_lift(case, monkeypatch):
    """parallel/halo.py's forward_tile_sharded / inverse_tile_sharded on a
    CPU mesh with K7 emulated CTA by CTA (each launch also equal to the
    plain version), against ako_tpu's forward_tile / inverse_tile under
    JAX: one launch per device and sharded level over its non-empty
    shards, the q heads stored once a level, by the launch on the device
    of pair 0."""
    from ako_tpu_torch.parallel import make_mesh

    w, h, n, ch, wavelet, wrap, devices = case
    launches: list = []
    lift, unlift = _emulated_shard_kernels(launches)
    monkeypatch.setattr(lk, "lift_level_shards", lift)
    monkeypatch.setattr(lk, "unlift_level_shards", unlift)
    mesh = make_mesh((n,), ("rows",), devices=[torch.device("cpu")] * n)
    if devices == 2:
        side = {id(s): i % 2 for i, s in enumerate(mesh.shards("rows"))}
        monkeypatch.setattr(halo, "_device_key", lambda s: side[id(s)])
    rng = np.random.default_rng(w * h + n)
    planes = rng.integers(-512, 512, size=(ch, h, w)).astype(np.int16)
    schedule = geometry.lift_schedule(w, h)
    qg = quantization.level_qg(schedule, ch, 16, 2, 1)
    ref_sched = ref_geometry.lift_schedule(w, h)
    ref = np.asarray(jax.jit(lambda p: ref_lifting.forward_tile(p, ref_sched, wavelet, wrap, qg,
                                                                False))(jnp.asarray(planes)))
    got = halo.forward_tile_sharded(torch.from_numpy(planes), schedule, wavelet, wrap, qg, mesh)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = halo.inverse_tile_sharded(torch.from_numpy(ref.copy()), schedule, wavelet, wrap, ch,
                                     mesh)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax.jit(
        lambda c: ref_lifting.inverse_tile(c, ref_sched, wavelet, wrap, ch, False))(ref)))
    plan = halo.plan_levels(schedule, n, wavelet, wrap)
    want = []
    for k in range(sum(plan)):
        pairs = [p for p in halo.shard_pairs(schedule.levels[k].target_h, n) if p[0] < p[1]]
        idx = [i for i, p in enumerate(halo.shard_pairs(schedule.levels[k].target_h, n))
               if p[0] < p[1]]
        groups = [tuple(p for i, p in zip(idx, pairs) if i % devices == d) for d in range(devices)]
        want += [(k, g) for g in groups if g]
    fwd = [(k, s) for kind, k, s, _ in launches if kind == "fwd"]
    inv = [(k, s) for kind, k, s, _ in launches if kind == "inv"]
    assert sorted(fwd) == sorted(want) and sorted(inv) == sorted(want)
    for k in range(sum(plan)):  # the heads once a level, by the launch holding pair 0
        assert [nh for kind, kk, s, nh in launches if kind == "fwd" and kk == k] == [
            int(s[0][0] == 0) for kind, kk, s, _ in launches if kind == "fwd" and kk == k]


def test_rows_window_maps_to_global_pairs():
    """A shard launch's axes: regions from the shard's first pair, cut at
    its last; a window buffer's segments by the line's rows (one, or for
    REPEAT one per run between wraps); REPEAT's window unclipped (pairs
    taken modulo n), others clipped to the line; and the source lines
    that the emulation repeats."""
    import os

    y = _Axis(50, 2, 1, 3, False, 20, 24)  # T = 25 over 8 shards: shard 5, its second region
    assert (y.r0, y.r1, y.lo, y.hi) == (22, 24, 19, 25)
    assert lk.row_window(25, (20, 24), DD, Wrap.CLAMP) == (17, 8)
    assert lk.row_window(25, (24, 25), DD, Wrap.CLAMP) == (21, 4)
    assert lk.row_window(25, (0, 4), DD, Wrap.REPEAT) == (-3, 10)
    assert lk.row_window(25, (0, 4), CDF, Wrap.MIRROR) == (0, 5)
    assert lk.row_window(25, (4, 8), HAAR, Wrap.REPEAT) == (4, 4)
    assert lk.pair_runs(-3, 7, 25, Wrap.REPEAT) == [(22, 25), (0, 7)]
    assert lk.pair_runs(-3, 7, 4, Wrap.REPEAT) == [(1, 4), (0, 4), (0, 3)]
    assert lk.pair_runs(2, 7, 25, Wrap.CLAMP) == [(2, 7)]
    # pairs [-5, 9) of 25 (h = 49) in a buffer, the window of pairs (0, 4) [-3, 7)
    win = torch.arange(2 * 14 * 3, dtype=torch.int16).view(1, 28, 3)
    segs = lk.window_segments(win, -5, _level(49, 3), (0, 4), DD, Wrap.REPEAT, 2)
    assert [(s.lo, s.t.shape[1]) for s in segs] == [(44, 5), (0, 14)]  # row 49 does not exist
    assert segs[0].t.data_ptr() == win[:, 4:].data_ptr()
    assert segs[1].t.data_ptr() == win[:, 10:].data_ptr()
    assert list(_shard_ctas([(0, 4), (4, 8), (8, 9)], 2, 3)) == (
        [((0, 4), i) for i in range(6)] + [((4, 8), i) for i in range(6)] + [((8, 9), i) for i in range(3)])
    src = open(os.path.join(os.path.dirname(lk.__file__), "..", "csrc", "lift_level.cu")).read()
    assert ("if constexpr (SHARDS) row = seg_row(seg_of(s, 0, s->segs, y.sample(j)), ch, y.sample(j));"
            in src)
    assert "while (i + 1 < s->shards && s->cta0[i + 1] <= b) ++i;" in src
    assert "const bool rv = !SHARDS || ((uintptr_t)row & 15) == 0;" in src
    assert "const int o0 = SHARDS ? s->out_p0 : 0, rows = SHARDS ? s->out_len : (h + 1) / 2;" in src
    assert "if (g.idx == 0 && y.r0 == o0 && (int)threadIdx.x < C)" in src
    assert "const int o0 = SHARDS ? 2 * s->out_p0 : 0, rows = SHARDS ? s->out_len : h;" in src

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
# K7: the row-window instances (lift_level_rows / unlift_level_rows) on
# one shard's pairs, and the sharded lift of parallel/halo.py through them

POISON_ROWS = 5  # poisoned rows on each side of a window buffer


class _Rows:
    """A CTA's rows of the window buffer, in place of _Axis.samples() for
    _load_planes: the row axis of a ROWS launch loads window slot j from
    the buffer's row 2 (lo - win_lo) + j (csrc/lift_level.cu lift_body),
    shifted past the poisoned rows before the window."""

    def __init__(self, y, win_lo, win_n):
        j = 2 * (y.lo - win_lo) + np.arange(2 * (y.hi - y.lo))
        assert (j >= 0).all() and (j < 2 * win_n).all(), "a row outside the shard's window"
        self.rows = POISON_ROWS + j

    def samples(self):
        return self.rows


def _poisoned(buf, rng, axis):
    """buf with POISON_ROWS random rows before and after it along `axis`."""
    shape = list(buf.shape)
    shape[axis] = POISON_ROWS
    pad = [rng.integers(-32768, 32768, size=shape) for _ in range(2)]
    return np.concatenate([pad[0], buf, pad[1]], axis=axis)


def emulate_lift_rows(win, win_lo, pairs, h, w, wav, wrap, region, seed=0):
    """lift_level_rows's lift, CTA by CTA: win is the shard's (C, 2 win_n,
    w) window of pairs [win_lo, win_lo + win_n) of a level of h rows ->
    (ll, b, c, d) of the shard's pairs, each (C, p1 - p0, tw) int64. The
    regions cover [p0, p1) from p0, the axes keep the level's global pair
    indices (edge steps at the line's ends alone), the buffer's rows
    outside the window are poisoned and every tap must hit a loaded slot."""
    rng = np.random.default_rng(seed)
    C = win.shape[0]
    p0, p1 = pairs
    tw, hl, rep = (w + 1) // 2, lk.LEVEL_HALO[wav], wrap == Wrap.REPEAT
    buf = _poisoned(win.astype(np.int64), rng, 1)
    pitch, plane, _, _ = lk.level_layout(C, region, wav, False)
    quads = np.zeros((4, C, p1 - p0, tw), np.int64)
    stores = np.zeros((C, p1 - p0, tw), np.int64)
    for iy, ix in itertools.product(range(-(-(p1 - p0) // region[0])), range(-(-tw // region[1]))):
        y = _Axis(h, region[0], iy, hl, rep, p0, p1)
        xa = _Axis(w, region[1], ix, hl, rep)
        raw = rng.integers(-32768, 32768, size=(C, plane // pitch, pitch))
        wr, wc = 2 * (y.hi - y.lo), len(xa.samples())
        sh = _load_planes(raw, buf, _Rows(y, win_lo, win.shape[1] // 2), xa, w)
        win_s = raw[:, :, sh:]
        m = np.zeros(win_s.shape, bool)
        m[:, :wr, :wc] = True
        _step(win_s[:, :wr], m[:, :wr], PREDICT, wav, max(xa.r0 - PL[wav], xa.lo),
              min(xa.r1 + PR[wav], xa.hi), xa, wrap)
        _step(win_s[:, :wr], m[:, :wr], UPDATE, wav, xa.r0, xa.r1, xa, wrap)
        c0, c1 = 2 * (xa.r0 - xa.lo), 2 * (xa.r1 - xa.lo)
        cols, cm = win_s[:, :, c0:c1].swapaxes(1, 2), m[:, :, c0:c1].swapaxes(1, 2)
        _step(cols, cm, PREDICT, wav, max(y.r0 - PL[wav], y.lo), min(y.r1 + PR[wav], y.hi), y, wrap)
        _step(cols, cm, UPDATE, wav, y.r0, y.r1, y, wrap)
        rr, cc = 2 * (np.arange(y.r0, y.r1) - y.lo), 2 * (np.arange(xa.r0, xa.r1) - xa.lo)
        for q, (dr, dc) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):  # ll, b, c, d
            quads[q, :, y.r0 - p0 : y.r1 - p0, xa.r0 : xa.r1] = win_s[:, rr + dr][:, :, cc + dc]
        stores[:, y.r0 - p0 : y.r1 - p0, xa.r0 : xa.r1] += 1
    assert (stores == 1).all(), "the regions do not tile the shard's quadrants"
    return quads


def emulate_unlift_rows(ll, chunk, win_lo, pairs, h, w, wav, wrap, region, seed=0):
    """unlift_level_rows, CTA by CTA: the (C, win_n, tw) LL window and the
    (C, 1 + 3 win_n tw) chunk window (q heads, then C, B, D rows), each
    poisoned outside the window, dequantized as they load -> the plane's
    rows [2 p0, min(2 p1, h)), (C, rows, w) int16."""
    rng = np.random.default_rng(seed)
    C, win_n, tw = ll.shape
    p0, p1 = pairs
    hl, rep = lk.LEVEL_HALO[wav], wrap == Wrap.REPEAT
    q = chunk[:, :1].astype(np.int64)[:, :, None]
    cbd = chunk[:, 1:].reshape(C, 3, win_n, tw).astype(np.int64)
    cbd = _w16(np.where(q[:, :, :, None] > 1, cbd * q[:, :, :, None], cbd))
    # LL, B, C, D windows, poisoned outside the window
    bufs = [_poisoned(x, rng, 1) for x in (ll.astype(np.int64), cbd[:, 1], cbd[:, 0], cbd[:, 2])]
    pitch, plane, _, _ = lk.level_layout(C, region, wav, False)
    o0, rows = 2 * p0, min(2 * p1, h) - 2 * p0
    out = np.zeros((C, rows, w), np.int64)
    stores = np.zeros(out.shape, np.int64)
    for iy, ix in itertools.product(range(-(-(p1 - p0) // region[0])), range(-(-tw // region[1]))):
        y = _Axis(h, region[0], iy, hl, rep, p0, p1)
        xa = _Axis(w, region[1], ix, hl, rep)
        gr = y.lo - win_lo + np.arange(y.hi - y.lo)  # csrc/lift_level.cu unlift_body's gr
        assert (gr >= 0).all() and (gr < win_n).all(), "a pair outside the shard's window"
        win_s = rng.integers(-32768, 32768, size=(C, plane // pitch, pitch))
        m = np.zeros(win_s.shape, bool)
        pc = xa.pairs()
        i, j = np.arange(len(gr))[:, None], np.arange(len(pc))[None, :]
        for b, (dr, dc) in zip(bufs, ((0, 0), (0, 1), (1, 0), (1, 1))):
            win_s[:, 2 * i + dr, 2 * j + dc] = b[:, POISON_ROWS + gr][:, :, pc]
        m[:, : 2 * len(gr), : 2 * len(pc)] = True
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
        out[:, row0 - o0 : row1 - o0, col0:col1] = rw[:, :, col0 - 2 * xa.lo : col1 - 2 * xa.lo]
        stores[:, row0 - o0 : row1 - o0, col0:col1] += 1
    assert (stores == 1).all(), "the regions do not tile the shard's rows"
    return out.astype(np.int16)


def _emulated_rows_kernels(heads):
    """Stand-ins for lk.lift_level_rows / unlift_level_rows that run the
    emulations at the region the wrappers pick (level_region for one tile
    on an H100 SXM), and check each launch against the plain version. The
    forward's q heads are stored by the launch's first region alone, at
    channel c's offset c (1 + 3 n) of the stream-layout rows; `heads`
    counts the stores."""

    def lift(win, schedule, k, pairs, win_lo, wavelet, wrap, qg):
        lvl = schedule.levels[k]
        C = win.shape[0]
        wav = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        region = lk.level_region(schedule, k, C, wavelet, 1, H100_SMS)
        ll, b, c, d = emulate_lift_rows(win.numpy(), win_lo, pairs, lvl.current_h, lvl.current_w,
                                        wav, wrap, region, seed=k)
        n = (pairs[1] - pairs[0]) * lvl.target_w
        out = np.zeros(C * (1 + 3 * n), np.int16)
        qs, gs = qg[k]
        for ch in range(C):
            base = ch * (1 + 3 * n)
            out[base] = qs[ch]
            heads[(k, pairs)] = heads.get((k, pairs), 0) + 1
            for j, quad in enumerate((c, b, d)):
                out[base + 1 + j * n : base + 1 + (j + 1) * n] = _quantize(
                    quad[ch], qs[ch], gs[ch]).reshape(-1)
        plain = lk.lift_level_rows_plain(win, schedule, k, pairs, win_lo, wavelet, wrap, qg)
        np.testing.assert_array_equal(ll, plain[0].numpy())
        np.testing.assert_array_equal(out, plain[1].numpy())
        return torch.from_numpy(ll.astype(np.int16)), torch.from_numpy(out)

    def unlift(ll, chunk, schedule, k, pairs, win_lo, wavelet, wrap):
        lvl = schedule.levels[k]
        C, win_n, tw = ll.shape
        wav = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        region = lk.level_region(schedule, k, C, wavelet, 1, H100_SMS)
        got = emulate_unlift_rows(ll.numpy(), chunk.numpy().reshape(C, -1), win_lo, pairs,
                                  lvl.current_h, lvl.current_w, wav, wrap, region, seed=k)
        plain = lk.unlift_level_rows_plain(ll, chunk, schedule, k, pairs, win_lo, wavelet, wrap)
        np.testing.assert_array_equal(got, plain.numpy())
        return torch.from_numpy(got)

    return lift, unlift


# (w, h, shards, channels, wavelet, wrap): the trouble shapes at narrow
# widths (raggedness is in the rows): the whole north-star tile's
# 1280 rows over 3 shards (every level ragged), the tractor's 2464 over 8
# (ragged from level 2, odd sides at level 5), T = 25 over 8 (a one-pair
# and an empty shard), odd and ragged sides, REPEAT and MIRROR at both ends
ROWS_CASES = [
    (40, 1280, 3, 1, DD, Wrap.MIRROR),
    (24, 2464, 8, 1, DD, Wrap.REPEAT),
    (20, 50, 8, 2, DD, Wrap.REPEAT),
    (20, 50, 8, 2, CDF, Wrap.MIRROR),
    (127, 127, 8, 2, CDF, Wrap.REPEAT),
    (96, 100, 8, 2, DD, Wrap.ZERO),
    (77, 93, 8, 1, DD, Wrap.CLAMP),
    (96, 100, 8, 2, HAAR, Wrap.REPEAT),
]


@pytest.mark.parametrize("case", ROWS_CASES,
                         ids=[f"{w}x{h}-{n}sh-{wv.name}-{wr.name}" for w, h, n, _, wv, wr in ROWS_CASES])
def test_rows_kernels_through_the_sharded_lift(case, monkeypatch):
    """parallel/halo.py's forward_tile_sharded / inverse_tile_sharded on a
    CPU mesh with K7 emulated CTA by CTA (each launch also equal to the
    plain version), against ako_tpu's forward_tile / inverse_tile under
    JAX: windows from the port's own helper, the shard's quadrant rows
    gathered to their wire offsets, one CTA per launch storing the q
    heads, a launch per non-empty shard of each sharded level."""
    from ako_tpu_torch.parallel import halo, make_mesh

    w, h, n, ch, wavelet, wrap = case
    heads: dict = {}
    lift, unlift = _emulated_rows_kernels(heads)
    monkeypatch.setattr(lk, "lift_level_rows", lift)
    monkeypatch.setattr(lk, "unlift_level_rows", unlift)
    rng = np.random.default_rng(w * h + n)
    planes = rng.integers(-512, 512, size=(ch, h, w)).astype(np.int16)
    schedule = geometry.lift_schedule(w, h)
    qg = quantization.level_qg(schedule, ch, 16, 2, 1)
    ref_sched = ref_geometry.lift_schedule(w, h)
    ref = np.asarray(jax.jit(lambda p: ref_lifting.forward_tile(p, ref_sched, wavelet, wrap, qg,
                                                                False))(jnp.asarray(planes)))
    mesh = make_mesh((n,), ("rows",), devices=[torch.device("cpu")] * n)
    got = halo.forward_tile_sharded(torch.from_numpy(planes), schedule, wavelet, wrap, qg, mesh)
    np.testing.assert_array_equal(got.numpy(), ref)
    plan = halo.plan_levels(schedule, n, wavelet, wrap)
    want = {(k, pr): ch for k in range(sum(plan))
            for pr in halo.shard_pairs(schedule.levels[k].target_h, n) if pr[0] < pr[1]}
    assert heads == want  # every non-empty shard launched once, its heads stored once a channel
    back = halo.inverse_tile_sharded(torch.from_numpy(ref.copy()), schedule, wavelet, wrap, ch,
                                     mesh)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax.jit(
        lambda c: ref_lifting.inverse_tile(c, ref_sched, wavelet, wrap, ch, False))(ref)))


def test_rows_window_maps_to_global_pairs():
    """A ROWS launch's axes: regions from the shard's first pair, cut at
    its last; the CTA's window slots inside the shard's window; REPEAT's
    window unclipped (pairs taken modulo n), others clipped to the line;
    and the source lines that the emulation repeats."""
    import os

    y = _Axis(50, 2, 1, 3, False, 20, 24)  # T = 25 over 8 shards: shard 5, its second region
    assert (y.r0, y.r1, y.lo, y.hi) == (22, 24, 19, 25)
    assert lk.row_window(25, (20, 24), DD, Wrap.CLAMP) == (17, 8)
    assert lk.row_window(25, (24, 25), DD, Wrap.CLAMP) == (21, 4)
    assert lk.row_window(25, (0, 4), DD, Wrap.REPEAT) == (-3, 10)
    assert lk.row_window(25, (0, 4), CDF, Wrap.MIRROR) == (0, 5)
    assert lk.row_window(25, (4, 8), HAAR, Wrap.REPEAT) == (4, 4)
    rows = _Rows(_Axis(50, 4, 0, 3, True, 0, 4), -3, 10)
    np.testing.assert_array_equal(rows.samples() - POISON_ROWS, np.arange(20))
    with pytest.raises(AssertionError, match="outside the shard's window"):
        _Rows(_Axis(50, 4, 0, 3, True, 0, 4), -2, 9)
    src = open(os.path.join(os.path.dirname(lk.__file__), "..", "csrc", "lift_level.cu")).read()
    assert "const int sr = ROWS ? 2 * (y.lo - a.win_lo) + j : y.sample(j);" in src
    assert "gr = ROWS ? y.lo + i - a.win_lo : y.pair(i);" in src
    assert "const int o0 = first_pair<ROWS>(a), rows = end_pair<ROWS>(a) - o0;" in src
    assert "if (g.idx == 0 && (int)threadIdx.x < C)" in src

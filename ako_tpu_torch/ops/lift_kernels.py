"""The lift kernels' wrappers, the counterpart of
ako_tpu/ops/pallas_lift.py, with their plain torch versions.

- Whole pyramids: `forward_pyramid` / `inverse_pyramid`, one launch of
  csrc/lift_pyramid.cu per shape group for every level from
  `pyramid_start` on, with the colour transform, quantize/gate and wire
  order fused (forward), or the dequantize and the inverse colour
  transform fused (inverse). The fused wiring's main path
  (ops/lifting.py forward_tiles / inverse_tiles).
- Levels too large for a pyramid block: `forward_levels` /
  `inverse_levels`, one launch of csrc/lift_level.cu per level
  (`lift_level` / `unlift_level`), every channel of a tile's region in
  one CTA, with the colour transform at level 0, quantize/gate and wire
  order fused (forward), or the dequantize and at level 0 the inverse
  colour transform fused (inverse). The fused wiring runs them on the
  levels before `pyramid_start`, and on every level when it is None.
- A device's shards of a row-sharded level (K7, the row-sharded lift of
  parallel/halo.py): `lift_level_shards` / `unlift_level_shards`, one
  launch of lift_level.cu's shard-table instances over the shards, their
  rows read in place from a table of segments, quantize/gate and the wire
  order fused (forward), or the dequantize (inverse).
  `lift_level_rows` / `unlift_level_rows` are its one-shard case on a
  window buffer of the shard's rows.
- One 2-D level per call, in the two wirings of pallas_lift.py: "fused",
  one K1 (K2) call per level, csrc/lift2d.cu ako_lift2d / ako_unlift2d
  (`lift2d_level` / `unlift2d_level`, the per-level API that
  lifting.forward_tile / inverse_tile take; the codec's fused route does
  not call them); and "split", the V-only K1v (K2v) of csrc/vlift.cu,
  wired as pallas_lift.py:167-172 and :242-247 computes it (the H pass is
  transpose -> V-lift -> transpose there), but with no transpose: the H
  pass lifts the stored plane along axis -1, and a level's two V passes
  along -2 share one launch (`vlift_level` / `vlift_pair`,
  `vunlift_level` / `vunlift_pair`), two launches a level each way.

The wiring is `mode`, read per call from AKO_TORCH_LIFT_MODE when not
given (the counterpart of AKO_TPU_PALLAS_MODE). A CUDA tensor launches
the hand-written Hopper kernels (built and bound by runtime/kernels.py);
if the build or the launch fails, the call raises. A CPU tensor takes
the plain torch version (ops/wavelets.py, and for the pyramids the level
loop below), which writes through the same offset and q/g tables the
kernels receive; it is also what the kernels are checked against on the
card. Unlike the Pallas kernels, these take odd dimensions.
"""

from __future__ import annotations

import functools
import math
import os
from typing import NamedTuple

import torch

from ako_tpu_torch.core.geometry import LiftLevel, LiftSchedule
from ako_tpu_torch.core.settings import Color, Wavelet, Wrap
from ako_tpu_torch.ops import wavelets
from ako_tpu_torch.ops.colorspace import to_interleaved_u8, to_planar_yuv
from ako_tpu_torch.ops.intmath import divt, i16, i32
from ako_tpu_torch.runtime import kernels

#: kernel launches per wrapper (one per call that reaches the card)
LAUNCHES = {
    "lift2d": 0, "unlift2d": 0, "vlift": 0, "vunlift": 0, "lift_pyramid": 0, "unlift_pyramid": 0,
    "lift_level": 0, "unlift_level": 0, "lift_level_shards": 0, "unlift_level_shards": 0,
}

#: shared memory a pyramid block may take: at most 64 KB keeps three
#: blocks on an SM (a block may have up to 227 KB on the H100, but one
#: block working through a large plane is slower than the per-level
#: kernels on it); and the forward pyramid's warps
#: (csrc/lift_pyramid.cu kFwdThreads / 32)
SMEM_BYTES = 65536
_FWD_WARPS = 16

MODES = ("fused", "split")


def lift_mode(mode: str | None = None) -> str:
    """The lift wiring: `mode`, or AKO_TORCH_LIFT_MODE (default
    "fused"); an unknown value raises."""
    if mode is None:
        mode = os.environ.get("AKO_TORCH_LIFT_MODE", "fused")
    if mode not in MODES:
        raise ValueError(f"unknown lift mode {mode!r}; expected one of {MODES}")
    return mode


def _check(t, shape, name: str) -> None:
    if t.dtype != torch.int16:
        raise TypeError(f"{name}: expected int16, got {t.dtype}")
    if tuple(t.shape[-2:]) != shape:
        raise ValueError(f"{name}: expected (..., {shape[0]}, {shape[1]}), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _on_card(t, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def lift2d_level(weff: Wavelet, wrap: Wrap, x, level, mode: str | None = None):
    """x: (..., current_h, current_w) int16 -> (ll, b, c, d), each
    (..., target_h, target_w) int16; what ops.wavelets.lift2d returns."""
    if lift_mode(mode) == "split":
        # the H pass along -1, then both halves' V passes in one launch
        lp, hp = vlift_level(weff, wrap, x, axis=-1)
        (ll, c), (b, d) = vlift_pair(weff, wrap, lp, hp)
        return ll, b, c, d
    if not _on_card(x, "lift2d_level"):
        return wavelets.lift2d(weff, wrap, x, level)
    _check(x, (level.current_h, level.current_w), "lift2d_level")
    batch = x.shape[:-2]
    n = math.prod(batch)
    th, tw = level.target_h, level.target_w
    ll, b, c, d = (x.new_empty(batch + (th, tw)) for _ in range(4))
    lp, hp = (x.new_empty((n, 2 * th, tw)) for _ in range(2))
    with torch.cuda.device(x.device):
        kernels.lift2d(
            x.data_ptr(), lp.data_ptr(), hp.data_ptr(),
            ll.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
            n, level.current_h, level.current_w, int(weff), int(wrap),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.count_launch(LAUNCHES, "lift2d")
    return ll, b, c, d


def unlift2d_level(weff: Wavelet, wrap: Wrap, ll, b, c, d, level, mode: str | None = None):
    """Quadrants (..., target_h, target_w) int16 -> plane (...,
    current_h, current_w) int16; what ops.wavelets.unlift2d returns."""
    if lift_mode(mode) == "split":
        # both halves' V passes in one launch, then the H pass along -1
        left, right = vunlift_pair(weff, wrap, (ll, c), (b, d), level.current_h)
        return vunlift_level(weff, wrap, left, right, level.current_w, axis=-1)
    if not _on_card(ll, "unlift2d_level"):
        return wavelets.unlift2d(weff, wrap, ll, b, c, d, level)
    th, tw = level.target_h, level.target_w
    for name, t in (("ll", ll), ("b", b), ("c", c), ("d", d)):
        _check(t, (th, tw), f"unlift2d_level {name}")
        if t.device != ll.device or t.shape != ll.shape:
            raise ValueError(f"unlift2d_level: {name} does not match ll")
    batch = ll.shape[:-2]
    n = math.prod(batch)
    out = ll.new_empty(batch + (level.current_h, level.current_w))
    left, right = (ll.new_empty((n, 2 * th, tw)) for _ in range(2))
    with torch.cuda.device(ll.device):
        kernels.unlift2d(
            ll.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
            left.data_ptr(), right.data_ptr(), out.data_ptr(),
            n, level.current_h, level.current_w, int(weff), int(wrap),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.count_launch(LAUNCHES, "unlift2d")
    return out


@functools.lru_cache(maxsize=256)
def _vlift_args(n: int, h: int, w: int, axis: int, wavelet: Wavelet, wrap: Wrap, groups: int):
    """The kernels' VliftArgs for `groups` calls on n planes (h, w) along
    `axis` (built once per shape)."""
    a = kernels.VliftArgs()
    a.n, a.h, a.w, a.axis = n, h, w, 1 if axis == -1 else 0
    a.wavelet, a.wrap, a.groups = wavelet, wrap, groups
    return a


def _check_axis(axis: int) -> None:
    if axis not in (-1, -2):
        raise ValueError(f"V-only lift: axis {axis}, expected -1 or -2")


def _vlift(wavelet: Wavelet, wrap: Wrap, xs, axis: int):
    """K1v on the same-shape planes `xs` (one or two calls): one launch on
    the card, the plain version on the CPU."""
    _check_axis(axis)
    if not _on_card(xs[0], "vlift_level"):
        return [wavelets.vlift(wavelet, wrap, x, axis) for x in xs]
    x = xs[0]
    h, w = x.shape[-2:]
    for t in xs:
        _check(t, (h, w), "vlift_level")
        if t.device != x.device or t.shape != x.shape:
            raise ValueError("vlift_pair: the planes do not match")
    shape = x.shape[:-2] + (((h + 1) // 2, w) if axis == -2 else (h, (w + 1) // 2))
    outs = [(x.new_empty(shape), x.new_empty(shape)) for _ in xs]
    args = _vlift_args(math.prod(x.shape[:-2]), h, w, axis, wavelet, wrap, len(xs))
    with torch.cuda.device(x.device):
        kernels.vlift(args, [t.data_ptr() for t in xs], [t.data_ptr() for o in outs for t in o],
                      torch.cuda.current_stream().cuda_stream)
    kernels.count_launch(LAUNCHES, "vlift")
    return outs


def _vunlift(wavelet: Wavelet, wrap: Wrap, pairs, out_len: int, axis: int):
    """K2v on the same-shape (lp, hp) `pairs` (one or two calls): one
    launch on the card, the plain version on the CPU."""
    _check_axis(axis)
    if not _on_card(pairs[0][0], "vunlift_level"):
        return [wavelets.vunlift(wavelet, wrap, lp, hp, out_len, axis) for lp, hp in pairs]
    lp0 = pairs[0][0]
    shape = tuple(lp0.shape[-2:])
    for lp, hp in pairs:
        _check(lp, shape, "vunlift_level lp")
        _check(hp, shape, "vunlift_level hp")
        if any(t.device != lp0.device or t.shape != lp0.shape for t in (lp, hp)):
            raise ValueError("vunlift_level: hp does not match lp")
    t = shape[axis]
    if out_len not in (2 * t - 1, 2 * t):
        raise ValueError(f"vunlift_level: out_len {out_len} does not fit {t} pairs")
    h, w = (out_len, shape[1]) if axis == -2 else (shape[0], out_len)
    outs = [lp0.new_empty(lp0.shape[:-2] + (h, w)) for _ in pairs]
    args = _vlift_args(math.prod(lp0.shape[:-2]), h, w, axis, wavelet, wrap, len(pairs))
    with torch.cuda.device(lp0.device):
        kernels.vunlift(args, [x.data_ptr() for p in pairs for x in p], [o.data_ptr() for o in outs],
                        torch.cuda.current_stream().cuda_stream)
    kernels.count_launch(LAUNCHES, "vunlift")
    return outs


def vlift_level(wavelet: Wavelet, wrap: Wrap, x, axis: int = -2):
    """x: (..., h, w) int16 -> (lp, hp), each (..., ceil(h/2), w) along
    the rows (axis -2) or (..., h, ceil(w/2)) along the columns (axis -1),
    int16; what ops.wavelets.vlift returns. One K1v launch."""
    return _vlift(wavelet, wrap, (x,), axis)[0]


def vlift_pair(wavelet: Wavelet, wrap: Wrap, x0, x1, axis: int = -2):
    """vlift_level of two planes of one shape, ((lp0, hp0), (lp1, hp1)),
    in one K1v launch."""
    return tuple(_vlift(wavelet, wrap, (x0, x1), axis))


def vunlift_level(wavelet: Wavelet, wrap: Wrap, lp, hp, out_len: int, axis: int = -2):
    """lp, hp (..., th, w) int16 -> (..., out_len, w) int16 (axis -2), or
    (..., h, tw) -> (..., h, out_len) (axis -1), out_len = 2*t or 2*t - 1;
    what ops.wavelets.vunlift returns. One K2v launch."""
    return _vunlift(wavelet, wrap, ((lp, hp),), out_len, axis)[0]


def vunlift_pair(wavelet: Wavelet, wrap: Wrap, pair0, pair1, out_len: int, axis: int = -2):
    """vunlift_level of two (lp, hp) pairs of one shape, (out0, out1), in
    one K2v launch."""
    return tuple(_vunlift(wavelet, wrap, (pair0, pair1), out_len, axis))


# ---------------------------------------------------------------------
# Whole pyramids


@functools.lru_cache(maxsize=256)
def level_offsets(schedule: LiftSchedule, channels: int) -> tuple:
    """Per level (encode order), the first element of its chunk in a
    tile's stream: the LP planes come first, then the levels smallest ->
    largest, each channel as [int16 q head][C][B][D]
    (library/misc.c:229-288)."""
    offs = [0] * len(schedule.levels)
    off = channels * schedule.lp_h * schedule.lp_w
    for k in reversed(range(len(schedule.levels))):
        offs[k] = off
        lvl = schedule.levels[k]
        off += channels * (1 + 3 * lvl.target_h * lvl.target_w)
    return tuple(offs)


def smem_plane(schedule: LiftSchedule, start: int) -> tuple:
    """(rows, pitch) of the shared-memory plane of a pyramid launch from
    level `start`: its input plane, with room for each later level's fake
    odd row and column (level s of the launch sits at stride 2^s)."""
    levels = schedule.levels[start:]
    h, w = (levels[0].current_h, levels[0].current_w) if levels else (
        schedule.lp_h, schedule.lp_w)
    rows = max([h] + [((2 * lvl.target_h - 1) << s) + 1 for s, lvl in enumerate(levels)])
    pitch = max([w] + [((2 * lvl.target_w - 1) << s) + 1 for s, lvl in enumerate(levels)])
    return rows, pitch


def pyramid_smem(schedule: LiftSchedule, channels: int, start: int) -> tuple:
    """Shared-memory bytes per block of (lift_pyramid, unlift_pyramid)
    launched from level `start`: each block holds its channel's plane, and
    the forward one from level 0 also a staging row of the u8 tile per
    warp."""
    rows, pitch = smem_plane(schedule, start)
    plane = -(-rows * pitch * 2 // 16) * 16
    fwd = plane
    if start == 0:
        fwd += _FWD_WARPS * (-(-schedule.tile_w * channels // 16) * 16)
    return fwd, plane


@functools.lru_cache(maxsize=256)
def pyramid_start(schedule: LiftSchedule, channels: int) -> int | None:
    """The first level whose plane both pyramid kernels hold within
    SMEM_BYTES of a block's shared memory (len(schedule.levels) when only
    the LP planes fit), or None when not even those fit or the tile has
    more channels than a cluster takes. A pure function of the shape and
    channel count: the levels before it run one lift_level /
    unlift_level launch each."""
    if channels > kernels.MAX_CLUSTER:
        return None
    total = len(schedule.levels)
    for k in range(total + 1):
        if total - k <= kernels.MAX_LEVELS and max(pyramid_smem(schedule, channels, k)) <= SMEM_BYTES:
            return k
    return None


def _quantize_gate(x, q, g):
    """Dead-zone gate + truncating quantization on an int16 quadrant;
    q/g broadcastable int32 (library/lifting.c:154-168)."""
    x32 = i32(x)
    keep = (x32 < -g) | (x32 > g)
    return i16(torch.where(keep, divt(x32, q.clamp(min=1)), 0))


def lift_levels(planes, stream, schedule: LiftSchedule, levels: range, wavelet: Wavelet,
                wrap: Wrap, qg, lift):
    """Lift the (T, C, h, w) int16 planes of the first of `levels` (encode
    order) through them with `lift` (lift2d_level, or the plain
    wavelets.lift2d), storing each level's q head and quantized, gated C,
    B, D at their offsets of the (T, coeff_count) `stream`; returns the
    last level's LL. The q/g table goes to the device in one copy."""
    T, C = planes.shape[:2]
    offs = level_offsets(schedule, C)
    cur = planes
    if not len(levels):
        return cur
    qg_dev = torch.tensor([[list(qs) for qs, _ in qg], [list(gs) for _, gs in qg]],
                          dtype=torch.int32).to(planes.device)
    for k in levels:
        lvl = schedule.levels[k]
        ll, b, c, d = lift(wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h),
                           wrap, cur, lvl)
        n = lvl.target_h * lvl.target_w
        chunk = stream[:, offs[k] : offs[k] + C * (1 + 3 * n)].view(T, C, 1 + 3 * n)
        q, g = qg_dev[0, k].view(C, 1, 1), qg_dev[1, k].view(C, 1, 1)
        chunk[..., 0] = i16(qg_dev[0, k])
        for j, quad in enumerate((c, b, d)):
            chunk[..., 1 + j * n : 1 + (j + 1) * n] = _quantize_gate(quad, q, g).view(T, C, n)
        cur = ll
    return cur


def store_lp(stream, ll) -> None:
    """The (T, C, lp_h, lp_w) LP planes into the head of the stream."""
    stream[:, : ll[0].numel()] = ll.reshape(ll.shape[0], -1)


def load_lp(coeffs, schedule: LiftSchedule, channels: int):
    """The (T, C, lp_h, lp_w) LP planes at the head of (T, coeff_count)
    streams."""
    lp_n = channels * schedule.lp_h * schedule.lp_w
    return coeffs[:, :lp_n].reshape(-1, channels, schedule.lp_h, schedule.lp_w).contiguous()


def unlift_levels(cur, coeffs, schedule: LiftSchedule, levels: range, wavelet: Wavelet,
                  wrap: Wrap, unlift):
    """Inverse of lift_levels: from the (T, C, h, w) LL planes below the
    last of `levels`, take each level largest index first, its C, B, D
    dequantized from the (T, coeff_count) streams by their q heads (the
    int16-wrapping multiply, skipped for q <= 1; library/lifting.c:30-40),
    through `unlift` (unlift2d_level, or the plain wavelets.unlift2d)."""
    T, C = cur.shape[:2]
    offs = level_offsets(schedule, C)
    for k in reversed(levels):
        lvl = schedule.levels[k]
        hh, hw = lvl.target_h, lvl.target_w
        n = hh * hw
        chunk = coeffs[:, offs[k] : offs[k] + C * (1 + 3 * n)].reshape(T, C, 1 + 3 * n)
        q = i32(chunk[..., :1]).view(T, C, 1, 1, 1)
        quads = chunk[..., 1:].reshape(T, C, 3, hh, hw)
        dequant = torch.where(q > 1, i16(i32(quads) * q), quads)
        c, b, d = (dequant[:, :, j].contiguous() for j in range(3))
        cur = unlift(wavelets.effective_wavelet(wavelet, hw, hh), wrap, cur, b, c, d, lvl)
    return cur


def _start_shape(schedule: LiftSchedule, start: int) -> tuple:
    """(h, w) of the plane a pyramid launch from level `start` takes."""
    if start < len(schedule.levels):
        lvl = schedule.levels[start]
        return lvl.current_h, lvl.current_w
    return schedule.lp_h, schedule.lp_w


@functools.lru_cache(maxsize=256)
def _pyramid_args(schedule: LiftSchedule, channels: int, start: int, wavelet: Wavelet, wrap: Wrap,
                  qg, color: Color, discard: bool):
    """The kernels' PyramidArgs for one shape group (built once per
    settings combination): the levels from `start`, their effective
    wavelets, chunk offsets and q/g (None for the inverse)."""
    levels = schedule.levels[start:]
    coeffs = schedule.coeff_count(channels)
    if len(levels) > kernels.MAX_LEVELS or channels > kernels.MAX_CHANNELS or coeffs >= 1 << 31:
        raise ValueError(f"pyramid: {len(levels)} levels, {channels} channels, {coeffs} "
                         "coefficients exceed the kernel's tables")
    a = kernels.PyramidArgs()
    a.levels, a.channels = len(levels), channels
    a.height, a.width = _start_shape(schedule, start)
    a.rows, a.pitch = smem_plane(schedule, start)
    a.coeffs, a.wrap, a.color, a.discard, a.u8 = coeffs, wrap, color, discard, start == 0
    offs = level_offsets(schedule, channels)
    for s, lvl in enumerate(levels):
        a.wavelet[s] = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        a.off[s] = offs[start + s]
        if qg is not None:
            qs, gs = qg[start + s]
            a.q[s][:channels] = qs
            a.g[s][:channels] = gs
    return a


def _check_pyramid(schedule: LiftSchedule, channels: int, start: int) -> None:
    if not 0 <= start <= len(schedule.levels):
        raise ValueError(f"pyramid: start level {start} outside 0..{len(schedule.levels)}")
    if max(pyramid_smem(schedule, channels, start)) > SMEM_BYTES:
        raise ValueError(f"pyramid: the plane of level {start} does not fit a block's shared "
                         f"memory (pyramid_start gives {pyramid_start(schedule, channels)})")


def _check_stream(stream, n_tiles: int, schedule: LiftSchedule, channels: int, name: str) -> None:
    shape = (n_tiles, schedule.coeff_count(channels))
    if stream.dtype != torch.int16 or tuple(stream.shape) != shape or not stream.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int16 stream of shape {shape}, got "
                         f"{stream.dtype} {tuple(stream.shape)}")


def forward_pyramid_plain(x, stream, schedule: LiftSchedule, start: int, wavelet: Wavelet,
                          wrap: Wrap, qg, color: Color, discard: bool) -> None:
    """The plain torch version of forward_pyramid, on any device."""
    planes = to_planar_yuv(x, color, discard) if start == 0 else x
    ll = lift_levels(planes, stream, schedule, range(start, len(schedule.levels)), wavelet, wrap,
                     qg, wavelets.lift2d)
    store_lp(stream, ll)


def inverse_pyramid_plain(coeffs, schedule: LiftSchedule, start: int, wavelet: Wavelet,
                          wrap: Wrap, channels: int, color: Color):
    """The plain torch version of inverse_pyramid, on any device."""
    ll = load_lp(coeffs, schedule, channels)
    planes = unlift_levels(ll, coeffs, schedule, range(start, len(schedule.levels)), wavelet, wrap,
                           wavelets.unlift2d)
    return to_interleaved_u8(planes, color, channels).contiguous() if start == 0 else planes


def forward_pyramid(x, stream, schedule: LiftSchedule, start: int, wavelet: Wavelet, wrap: Wrap,
                    qg, color: Color, discard: bool) -> None:
    """Levels [start, len(levels)) of every tile, and its LP planes, into
    `stream`, the (T, coeff_count) int16 streams, at their wire offsets,
    C, B and D quantized and gated by `qg` (quantization.level_qg's
    table): one lift_pyramid launch. x is the (T, tile_h, tile_w, C) u8
    tiles when start is 0 (colour transform `color` and discard-non-
    visible applied to them), else the contiguous (T, C, h, w) int16 LL
    planes of level `start`."""
    channels = x.shape[-1] if start == 0 else x.shape[1]
    if not _on_card(x, "forward_pyramid"):
        forward_pyramid_plain(x, stream, schedule, start, wavelet, wrap, qg, color, discard)
        return
    _check_pyramid(schedule, channels, start)
    h, w = _start_shape(schedule, start)
    shape, dtype = ((h, w, channels), torch.uint8) if start == 0 else ((channels, h, w), torch.int16)
    if x.dtype != dtype or tuple(x.shape[1:]) != shape or not x.is_contiguous():
        raise ValueError(f"forward_pyramid: expected contiguous {dtype} (T, {shape}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    _check_stream(stream, x.shape[0], schedule, channels, "forward_pyramid")
    if stream.device != x.device:
        raise ValueError("forward_pyramid: the stream is not on the tiles' device")
    args = _pyramid_args(schedule, channels, start, wavelet, wrap, tuple(qg), color, discard)
    with torch.cuda.device(x.device):
        kernels.lift_pyramid(args, x.data_ptr(), stream.data_ptr(), x.shape[0],
                             torch.cuda.current_stream().cuda_stream)
    kernels.count_launch(LAUNCHES, "lift_pyramid")


def inverse_pyramid(coeffs, schedule: LiftSchedule, start: int, wavelet: Wavelet, wrap: Wrap,
                    channels: int, color: Color):
    """The (T, coeff_count) int16 streams -> the tiles through levels
    [start, len(levels)) in reverse, dequantized by the streams' q heads:
    one unlift_pyramid launch. Returns the (T, tile_h, tile_w, C) u8
    tiles (inverse colour transform `color`, saturated) when start is 0,
    else the (T, C, h, w) int16 planes of level `start`."""
    if not _on_card(coeffs, "inverse_pyramid"):
        return inverse_pyramid_plain(coeffs, schedule, start, wavelet, wrap, channels, color)
    _check_pyramid(schedule, channels, start)
    _check_stream(coeffs, coeffs.shape[0], schedule, channels, "inverse_pyramid")
    h, w = _start_shape(schedule, start)
    n = coeffs.shape[0]
    if start == 0:
        out = torch.empty((n, h, w, channels), dtype=torch.uint8, device=coeffs.device)
    else:
        out = torch.empty((n, channels, h, w), dtype=torch.int16, device=coeffs.device)
    args = _pyramid_args(schedule, channels, start, wavelet, wrap, None, color, False)
    with torch.cuda.device(coeffs.device):
        kernels.unlift_pyramid(args, coeffs.data_ptr(), out.data_ptr(), n,
                               torch.cuda.current_stream().cuda_stream)
    kernels.count_launch(LAUNCHES, "unlift_pyramid")
    return out


# ---------------------------------------------------------------------
# Levels too large for a pyramid block


#: the level kernels' warps (csrc/lift_level.cu kThreads / 32), and the
#: shared memory a CTA may take so that two fit an SM of an H100 (228 KB
#: an SM, of which 1 KB is reserved per CTA)
_LEVEL_WARPS = 16
LEVEL_SMEM_BYTES = 233472 // 2 - 1024
#: a level CTA's region, (quadrant rows, quadrant columns), largest first:
#: 64 columns make a warp's row of int16 stores 128 bytes
LEVEL_REGIONS = ((32, 64), (16, 64), (16, 32), (8, 32), (8, 16), (4, 16), (4, 8), (2, 8))
#: halo pairs on each side of a region (csrc/lift_level.cu halo())
LEVEL_HALO = {Wavelet.DD137: 3, Wavelet.CDF53: 1, Wavelet.HAAR: 0}


def level_layout(channels: int, region: tuple, wavelet_eff: Wavelet, stage: bool) -> tuple:
    """The shared memory of a lift_level / unlift_level CTA, (pitch, plane,
    stage, smem): int16 per window row, the window's 2 * (rw + 2 halo)
    samples and room for the 16-byte copies' shift of up to 6 samples, a
    multiple of 8; int16 per channel's window of 2 * (rh + 2 halo) rows;
    bytes per staging row of u8 pixels (the window's columns and 32 bytes
    for the 16-byte copies' ends, a multiple of 16), two a warp for the
    forward from u8 tiles (`stage`); and the CTA's bytes."""
    hl = LEVEL_HALO[Wavelet(wavelet_eff)]
    cols, rows = 2 * (region[1] + 2 * hl), 2 * (region[0] + 2 * hl)
    pitch = -(-(cols + 6) // 8) * 8
    row_stage = -(-(cols * channels + 32) // 16) * 16
    smem = 2 * channels * rows * pitch + (2 * _LEVEL_WARPS * row_stage if stage else 0)
    return pitch, rows * pitch, row_stage, smem


@functools.lru_cache(maxsize=8)
def sm_count(device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fitting_regions(schedule: LiftSchedule, k: int, channels: int, wavelet: Wavelet) -> list:
    lvl = schedule.levels[k]
    weff = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
    fits = [r for r in LEVEL_REGIONS if level_layout(channels, r, weff, True)[3] <= LEVEL_SMEM_BYTES]
    if not fits or channels > kernels.MAX_LEVEL_CHANNELS:
        raise ValueError(f"lift_level: no region fits {channels} channels")
    return fits


def _pick_region(fits: list, ctas, sms: int) -> tuple:
    for r in fits:
        n = ctas(r)
        if sms // 2 <= n <= sms or n >= 2 * sms:
            return r
    return fits[-1]


@functools.lru_cache(maxsize=256)
def level_region(schedule: LiftSchedule, k: int, channels: int, wavelet: Wavelet, tiles: int,
                 sms: int) -> tuple:
    """The region of a lift_level / unlift_level CTA on level k of `tiles`
    tiles on a card of `sms` SMs: the first of LEVEL_REGIONS whose
    CTA, staging included, fits LEVEL_SMEM_BYTES and whose grid loads the
    SMs evenly: from half the SMs to all of them (a CTA an SM at most), or
    at least two CTAs for every SM; else the smallest that fits (the most
    CTAs on a small plane). A grid of one to two CTAs an SM leaves some
    SMs two CTAs' work and the rest one, and each halving of the region
    adds halo (a 16x64 region reads 1.5x its samples with DD 13/7, an 8x32
    one 2.1x): on the default whole tile and an H100 SXM's 132 SMs this
    takes 16x64 at levels 0 and 1 and 8x32 at level 2, the fastest of the
    list there (chip_probe.py levels). A pure function of the shape and
    the card."""
    lvl = schedule.levels[k]
    return _pick_region(_fitting_regions(schedule, k, channels, wavelet),
                        lambda r: tiles * -(-lvl.target_h // r[0]) * -(-lvl.target_w // r[1]), sms)


@functools.lru_cache(maxsize=1024)
def shards_region(schedule: LiftSchedule, k: int, channels: int, wavelet: Wavelet, shards: tuple,
                  sms: int) -> tuple:
    """The region of a K7 launch over `shards`, the (p0, p1) pairs of level
    k it lifts: level_region's rule on the launch's CTAs (each shard's
    regions start at its first pair). A launch over every shard of a level,
    as on one card, takes the whole level's region (16x64 at the whole
    tile's levels 0 and 1 over 8 shards, 320 and 96 CTAs)."""
    tw = schedule.levels[k].target_w
    return _pick_region(
        _fitting_regions(schedule, k, channels, wavelet),
        lambda r: sum(-(-(p1 - p0) // r[0]) for p0, p1 in shards) * -(-tw // r[1]), sms)


@functools.lru_cache(maxsize=256)
def _level_args(schedule: LiftSchedule, k: int, channels: int, wavelet: Wavelet, wrap: Wrap, qg,
                color: Color, discard: bool, ll_stride: int, region: tuple):
    """The kernels' LevelArgs for level k of one shape group (built once
    per settings combination) with CTAs of `region`; q/g None for the
    inverse, which stages no u8 rows."""
    coeffs = schedule.coeff_count(channels)
    if channels > kernels.MAX_LEVEL_CHANNELS or coeffs >= 1 << 31:
        raise ValueError(f"lift_level: {channels} channels, {coeffs} coefficients exceed the "
                         "kernel's tables")
    lvl = schedule.levels[k]
    a = kernels.LevelArgs()
    a.channels, a.height, a.width = channels, lvl.current_h, lvl.current_w
    a.rh, a.rw = region
    a.wavelet = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
    a.wrap, a.color, a.discard, a.u8 = wrap, color, discard, k == 0
    a.coeffs, a.off, a.ll_stride = coeffs, level_offsets(schedule, channels)[k], ll_stride
    a.pitch, a.plane, a.stage, a.smem = level_layout(channels, region, a.wavelet,
                                                     k == 0 and qg is not None)
    if qg is not None:
        qs, gs = qg[k]
        a.q[:channels] = qs
        a.g[:channels] = gs
    return a


def _check_ll(ll, shape, name: str) -> None:
    """An LL input or output: int16 (T, C, th, tw), each tile's planes
    contiguous (tiles may be apart, as in the streams' LP head)."""
    c, th, tw = shape
    if (ll.dtype != torch.int16 or tuple(ll.shape[1:]) != shape
            or tuple(ll.stride()[1:]) != (th * tw, tw, 1) or ll.stride(0) < c * th * tw):
        raise ValueError(f"{name}: expected int16 (T, {c}, {th}, {tw}) planes with contiguous "
                         f"tiles, got {ll.dtype} {tuple(ll.shape)} strides {ll.stride()}")


def lp_view(stream, schedule: LiftSchedule, channels: int):
    """The (T, C, lp_h, lp_w) LP planes at the head of (T, coeff_count)
    streams, as a view."""
    return stream[:, : channels * schedule.lp_h * schedule.lp_w].view(
        stream.shape[0], channels, schedule.lp_h, schedule.lp_w)


def forward_levels_plain(x, stream, schedule: LiftSchedule, levels: range, wavelet: Wavelet,
                         wrap: Wrap, qg, color: Color, discard: bool):
    """The plain torch version of forward_levels (and of lift_level for
    one level), on any device: to_planar_yuv, lift_levels and, when the
    levels end at the schedule's last, store_lp."""
    planes = to_planar_yuv(x, color, discard) if levels.start == 0 else x
    ll = lift_levels(planes, stream, schedule, levels, wavelet, wrap, qg, wavelets.lift2d)
    if levels.stop == len(schedule.levels):
        store_lp(stream, ll)
    return ll


def inverse_levels_plain(ll, coeffs, schedule: LiftSchedule, levels: range, wavelet: Wavelet,
                         wrap: Wrap, channels: int, color: Color):
    """The plain torch version of inverse_levels (and of unlift_level for
    one level), on any device: unlift_levels and, from level 0,
    to_interleaved_u8."""
    planes = unlift_levels(ll, coeffs, schedule, levels, wavelet, wrap, wavelets.unlift2d)
    if levels.start == 0:
        return to_interleaved_u8(planes, color, channels).contiguous()
    return planes


def lift_level(x, stream, schedule: LiftSchedule, k: int, wavelet: Wavelet, wrap: Wrap, qg,
               color: Color, discard: bool):
    """Level k of every tile into `stream`, the (T, coeff_count) int16
    streams: its q head and C, B, D quantized and gated by `qg` at their
    wire offsets; returns the level's (T, C, th, tw) LL, at the
    schedule's last level a view of the streams' LP head, where it is
    stored. x is the (T, tile_h, tile_w, C) u8 tiles when k is 0 (colour
    transform `color` and discard-non-visible applied to them), else the
    contiguous (T, C, h, w) int16 LL of level k - 1. One lift_level
    launch, its CTAs' region level_region's."""
    last = k == len(schedule.levels) - 1
    if not _on_card(x, "lift_level"):
        return forward_levels_plain(x, stream, schedule, range(k, k + 1), wavelet, wrap, qg,
                                    color, discard)
    lvl = schedule.levels[k]
    channels = x.shape[-1] if k == 0 else x.shape[1]
    h, w = lvl.current_h, lvl.current_w
    shape, dtype = ((h, w, channels), torch.uint8) if k == 0 else ((channels, h, w), torch.int16)
    if x.dtype != dtype or tuple(x.shape[1:]) != shape or not x.is_contiguous():
        raise ValueError(f"lift_level: expected contiguous {dtype} (T, {shape}), got "
                         f"{x.dtype} {tuple(x.shape)}")
    n = x.shape[0]
    _check_stream(stream, n, schedule, channels, "lift_level")
    if stream.device != x.device:
        raise ValueError("lift_level: the stream is not on the tiles' device")
    if last:
        ll = lp_view(stream, schedule, channels)
    else:
        ll = x.new_empty((n, channels, lvl.target_h, lvl.target_w), dtype=torch.int16)
    args = _level_args(schedule, k, channels, wavelet, wrap, tuple(qg), color, discard,
                       ll.stride(0),
                       level_region(schedule, k, channels, wavelet, n, sm_count(x.device)))
    with torch.cuda.device(x.device):
        kernels.lift_level(args, x.data_ptr(), stream.data_ptr(), ll.data_ptr(), n,
                           torch.cuda.current_stream().cuda_stream)
    kernels.count_launch(LAUNCHES, "lift_level")
    return ll


def unlift_level(ll, coeffs, schedule: LiftSchedule, k: int, wavelet: Wavelet, wrap: Wrap,
                 channels: int, color: Color):
    """Inverse of lift_level: the (T, C, th, tw) int16 LL of level k (each
    tile's planes contiguous, e.g. lp_view of the streams) and its C, B, D
    from the (T, coeff_count) streams, dequantized by their q heads ->
    the (T, C, h, w) int16 plane of level k, or at level 0 the (T, tile_h,
    tile_w, C) u8 tiles (inverse colour transform `color`, saturated).
    One unlift_level launch."""
    if not _on_card(coeffs, "unlift_level"):
        return inverse_levels_plain(ll, coeffs, schedule, range(k, k + 1), wavelet, wrap,
                                    channels, color)
    lvl = schedule.levels[k]
    n = coeffs.shape[0]
    _check_stream(coeffs, n, schedule, channels, "unlift_level")
    _check_ll(ll, (channels, lvl.target_h, lvl.target_w), "unlift_level")
    if ll.device != coeffs.device or ll.shape[0] != n:
        raise ValueError("unlift_level: ll does not match the streams")
    h, w = lvl.current_h, lvl.current_w
    if k == 0:
        out = torch.empty((n, h, w, channels), dtype=torch.uint8, device=coeffs.device)
    else:
        out = torch.empty((n, channels, h, w), dtype=torch.int16, device=coeffs.device)
    args = _level_args(schedule, k, channels, wavelet, wrap, None, color, False, ll.stride(0),
                       level_region(schedule, k, channels, wavelet, n, sm_count(coeffs.device)))
    with torch.cuda.device(coeffs.device):
        kernels.unlift_level(args, ll.data_ptr(), coeffs.data_ptr(), out.data_ptr(), n,
                             torch.cuda.current_stream().cuda_stream)
    kernels.count_launch(LAUNCHES, "unlift_level")
    return out


def _check_levels(schedule: LiftSchedule, levels: range, name: str) -> None:
    if not len(levels) or levels.step != 1 or levels.start < 0 or levels.stop > len(schedule.levels):
        raise ValueError(f"{name}: levels {levels} are not a run of the schedule's "
                         f"{len(schedule.levels)}")


def forward_levels(x, stream, schedule: LiftSchedule, levels: range, wavelet: Wavelet, wrap: Wrap,
                   qg, color: Color, discard: bool):
    """Lift `levels` (a run of the schedule's, encode order) of every tile
    into `stream`, each level's q head and quantized, gated C, B, D at
    their wire offsets, and return the last level's (T, C, th, tw) LL;
    when the levels end at the schedule's last, that LL is the LP planes
    and is stored at the head of the stream too. x is as lift_level's for
    the first level. On the card one lift_level launch per level; the
    plain version is to_planar_yuv + lift_levels (+ store_lp)."""
    _check_levels(schedule, levels, "forward_levels")
    if not _on_card(x, "forward_levels"):
        return forward_levels_plain(x, stream, schedule, levels, wavelet, wrap, qg, color, discard)
    for k in levels:
        x = lift_level(x, stream, schedule, k, wavelet, wrap, qg, color, discard)
    return x


def inverse_levels(ll, coeffs, schedule: LiftSchedule, levels: range, wavelet: Wavelet,
                   wrap: Wrap, channels: int, color: Color):
    """Inverse of forward_levels: from the (T, C, th, tw) LL below the last
    of `levels` (each tile's planes contiguous, e.g. lp_view of the
    streams), each level largest index first, its C, B, D dequantized
    from the (T, coeff_count) streams by their q heads. Returns the
    (T, C, h, w) int16 planes of the first level, or the (T, tile_h,
    tile_w, C) u8 tiles when that is level 0. On the card one
    unlift_level launch per level; the plain version is unlift_levels (+
    to_interleaved_u8)."""
    _check_levels(schedule, levels, "inverse_levels")
    if not _on_card(coeffs, "inverse_levels"):
        return inverse_levels_plain(ll, coeffs, schedule, levels, wavelet, wrap, channels, color)
    for k in reversed(levels):
        ll = unlift_level(ll, coeffs, schedule, k, wavelet, wrap, channels, color)
    return ll


# ---------------------------------------------------------------------
# A device's shards of a row-sharded level (K7)


def row_window(n: int, pairs: tuple, wavelet_eff: Wavelet, wrap: Wrap) -> tuple:
    """(win_lo, win_n): the pairs of the window of a shard that owns the
    pairs [p0, p1) of a level of n pairs: its pairs and LEVEL_HALO on each
    side, clipped to the line, or for REPEAT unclipped (pair p of the
    window is the line's p modulo n). Every tap of the shard's outputs
    lies in it."""
    p0, p1 = pairs
    hl = LEVEL_HALO[Wavelet(wavelet_eff)]
    if wrap == Wrap.REPEAT:
        return p0 - hl, p1 - p0 + 2 * hl
    lo = max(p0 - hl, 0)
    return lo, min(p1 + hl, n) - lo


def window_pairs(win_lo: int, win_n: int, T: int, wrap: Wrap) -> list:
    """The level's pair at each window pair: pair p, or p modulo T for
    REPEAT."""
    return [p % T if wrap == Wrap.REPEAT else p for p in range(win_lo, win_lo + win_n)]


def window_rows(win_lo: int, win_n: int, lvl, wrap: Wrap) -> list:
    """The plane's row at each row of a forward window: two a pair, an
    odd height's fake odd row its last even one."""
    return [min(2 * p + odd, lvl.current_h - 1)
            for p in window_pairs(win_lo, win_n, lvl.target_h, wrap) for odd in (0, 1)]


def pair_runs(lo: int, hi: int, n: int, wrap: Wrap) -> list:
    """Window pairs [lo, hi) of a line of n pairs as runs [a, b) of the
    line's pairs, in window order: one run, or for REPEAT one per stretch
    between its wraps modulo n."""
    if wrap != Wrap.REPEAT:
        return [(lo, hi)]
    runs = []
    while lo < hi:
        a = lo % n
        b = min(n, a + hi - lo)
        runs.append((a, b))
        lo += b - a
    return runs


class Segment(NamedTuple):
    """Rows [lo, lo + t.shape[-2]) of a K7 launch's source, read in place:
    for the forward a (C, rows, current_w) view of the level's plane rows
    from lo; for the inverse a (C, pairs, target_w) view of its LL rows or
    a (C, 3, pairs, target_w) view of its C, B, D rows from pair lo. Any
    strides, but rows contiguous."""

    lo: int
    t: torch.Tensor


def window_segments(win, win_lo: int, lvl, pairs: tuple, wavelet_eff: Wavelet, wrap: Wrap,
                    per_pair: int) -> list:
    """The window of the shard that owns `pairs` (row_window's pairs) in a
    window buffer of the level's pairs from win_lo (along dim -2, per_pair
    rows a pair: 2 for the forward's plane rows, 1 for the inverse's LL or
    C, B, D rows), as Segments by the plane's rows (below its height) or
    the level's pairs: one, or for REPEAT's wrapped window one per run of
    pair_runs. The buffer's other pairs are not in them."""
    T = lvl.target_h
    lo, n = row_window(T, pairs, wavelet_eff, wrap)
    limit = lvl.current_h if per_pair == 2 else T
    segs, i = [], per_pair * (lo - win_lo)
    for a, b in pair_runs(lo, lo + n, T, wrap):
        rows = min(per_pair * b, limit) - per_pair * a
        segs.append(Segment(per_pair * a, win.narrow(-2, i, rows)))
        i += per_pair * (b - a)
    return segs


def _check_rows(schedule: LiftSchedule, k: int, pairs: tuple, win_lo: int, win_n: int,
                wavelet: Wavelet, wrap: Wrap, name: str) -> None:
    lvl = schedule.levels[k]
    p0, p1 = pairs
    lo, wn = row_window(lvl.target_h, pairs,
                        wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h), wrap)
    if not 0 <= p0 < p1 <= lvl.target_h or win_lo > lo or win_lo + win_n < lo + wn:
        raise ValueError(f"{name}: pairs {pairs} of {lvl.target_h} with a window of pairs "
                         f"[{win_lo}, {win_lo + win_n}), which must hold [{lo}, {lo + wn})")


def _spans(segs) -> list:
    """The segments' rows [lo, hi), sorted."""
    return sorted((s.lo, s.lo + s.t.shape[-2]) for s in segs)


def _covers(spans, end: int) -> bool:
    """The spans hold every row of [0, end)."""
    a = 0
    for lo, hi in spans:
        if lo <= a < hi:
            a = hi
    return a >= end


def _covered(spans, runs) -> bool:
    """Every row of the runs [a, b) lies in a span."""
    for a, b in runs:
        for lo, hi in spans:
            if lo <= a < hi:
                a = hi
            if a >= b:
                break
        if a < b:
            return False
    return True


def _check_segs(segs, shape: tuple, device, name: str) -> None:
    for s in segs:
        t = s.t
        if (t.dtype != torch.int16 or t.dim() != len(shape) + 1 or tuple(t.shape[:-2]) != shape[:-1]
                or t.shape[-1] != shape[-1] or t.shape[-2] < 1 or t.stride(-1) != 1
                or t.device != device):
            raise ValueError(f"{name}: a segment of {t.dtype} {tuple(t.shape)} strides "
                             f"{t.stride()} on {t.device}; expected int16 ({', '.join(map(str, shape[:-1]))}, "
                             f"rows, {shape[-1]}) rows contiguous on {device}")


def _check_shards(schedule: LiftSchedule, k: int, shards: tuple, seg_tables, out_p0: int,
                  out_len: int, wavelet: Wavelet, wrap: Wrap, inverse: bool, name: str) -> None:
    """A K7 launch's table: 1 to MAX_SHARDS non-empty shards in pair order,
    inside the outputs, at most MAX_SEGS segments, and each table of
    segments holding every row (forward) or pair (inverse) of each shard's
    window (row_window: its pairs and halo, REPEAT's wrapped)."""
    lvl = schedule.levels[k]
    T, h = lvl.target_h, lvl.current_h
    if not 1 <= len(shards) <= kernels.MAX_SHARDS:
        raise ValueError(f"{name}: {len(shards)} shards; a launch takes 1 to {kernels.MAX_SHARDS}")
    n_segs = sum(len(t) for t in seg_tables)
    if n_segs > kernels.MAX_SEGS or not all(seg_tables):
        raise ValueError(f"{name}: {n_segs} segments; a launch takes 1 to {kernels.MAX_SEGS} "
                         "of each source")
    weff = wavelets.effective_wavelet(wavelet, lvl.target_w, T)
    # a table that holds the whole source holds every window
    partial = [sp for sp in map(_spans, seg_tables) if not _covers(sp, T if inverse else h)]
    prev = 0
    for p0, p1 in shards:
        inside = (2 * out_p0 <= 2 * p0 and min(2 * p1, h) <= 2 * out_p0 + out_len if inverse
                  else out_p0 <= p0 and p1 <= out_p0 + out_len)
        if not prev <= p0 < p1 <= T or not inside:
            raise ValueError(f"{name}: shards {shards} of {T} pairs, outputs from {out_p0} "
                             f"({out_len} a channel): each non-empty, in order, inside the outputs")
        prev = p1
        if not partial:
            continue
        lo, wn = row_window(T, (p0, p1), weff, wrap)
        runs = pair_runs(lo, lo + wn, T, wrap)
        if not inverse:
            runs = [(2 * a, min(2 * b, h)) for a, b in runs]
        for spans in partial:
            if not _covered(spans, runs):
                raise ValueError(f"{name}: the segments do not hold the window of pairs "
                                 f"[{lo}, {lo + wn}) of shard {(p0, p1)}")


@functools.lru_cache(maxsize=1024)
def _k7_args(schedule: LiftSchedule, k: int, channels: int, wavelet: Wavelet, wrap: Wrap, qg,
             region: tuple):
    """The kernels' LevelArgs for a K7 launch on level k: int16 planes of
    one tile, the outputs addressed by the ShardArgs (off 0), q/g (None
    for the inverse)."""
    base = _level_args(schedule, k, channels, wavelet, wrap, None, Color.NONE, False, 0, region)
    a = kernels.LevelArgs.from_buffer_copy(base)
    a.u8, a.coeffs, a.off = 0, 0, 0
    if qg is not None:
        qs, gs = qg[k]
        a.q[:channels] = qs
        a.g[:channels] = gs
    return a


def _shard_table(shards: tuple, seg_tables, out_p0: int, out_len: int, heads=None):
    """A ShardArgs: the shards and the segments, table after table (the
    inverse's LL ones first, `lls` of them)."""
    t = kernels.ShardArgs()
    t.shards = len(shards)
    for i, (p0, p1) in enumerate(shards):
        t.p0[i], t.p1[i] = p0, p1
    segs = [s for table in seg_tables for s in table]
    t.segs, t.lls = len(segs), len(seg_tables[0]) if len(seg_tables) > 1 else 0
    for e, s in zip(t.seg, segs):
        x = s.t
        e.base, e.chan, e.pitch = x.data_ptr(), x.stride(0), x.stride(-2)
        e.quad = x.stride(1) if x.dim() == 4 else 0
        e.r0, e.r1 = s.lo, s.lo + x.shape[-2]
    t.out_p0, t.out_len = out_p0, out_len
    if heads is not None:
        t.heads, t.head_stride = heads.data_ptr(), heads.stride(0)
    return t


def _window_of(segs, idx, dim: int):
    """Rows idx (along dim) of the source the segments hold, each from the
    first segment that holds it, in that order along dim."""
    picks: dict = {}
    for j, r in enumerate(idx):
        i = next(i for i, s in enumerate(segs) if s.lo <= r < s.lo + s.t.shape[-2])
        picks.setdefault(i, ([], []))
        picks[i][0].append(j)
        picks[i][1].append(r - segs[i].lo)
    t0 = segs[0].t
    out = t0.new_empty((*t0.shape[:dim], len(idx), *t0.shape[dim + 1 :]))
    for i, (js, rs) in picks.items():
        src = segs[i].t.index_select(dim, torch.tensor(rs, device=t0.device))
        out.index_copy_(dim, torch.tensor(js, device=t0.device), src)
    return out


def lift_level_shards_plain(segs, schedule: LiftSchedule, k: int, shards, ll, chunk, out_p0: int,
                            wavelet: Wavelet, wrap: Wrap, qg) -> None:
    """The plain torch version of lift_level_shards, on any device: each
    shard's window of rows (row_window) assembled from the segments by
    indexing, lift_level_rows_plain on it, its outputs stored at their
    offsets."""
    lvl = schedule.levels[k]
    C, out_len, tw = ll.shape
    weff = wavelets.effective_wavelet(wavelet, tw, lvl.target_h)
    cv = chunk.view(C, 1 + 3 * out_len * tw)
    quads = cv[:, 1:].view(C, 3, out_len, tw)
    for p0, p1 in shards:
        win_lo, win_n = row_window(lvl.target_h, (p0, p1), weff, wrap)
        win = _window_of(segs, window_rows(win_lo, win_n, lvl, wrap), 1)
        sll, rows = lift_level_rows_plain(win, schedule, k, (p0, p1), win_lo, wavelet, wrap, qg)
        rv = rows.view(C, 1 + 3 * (p1 - p0) * tw)
        ll[:, p0 - out_p0 : p1 - out_p0] = sll
        quads[:, :, p0 - out_p0 : p1 - out_p0] = rv[:, 1:].view(C, 3, p1 - p0, tw)
        if p0 == out_p0:
            cv[:, 0] = rv[:, 0]


def unlift_level_shards_plain(ll_segs, cbd_segs, heads, schedule: LiftSchedule, k: int, shards,
                              out, out_p0: int, wavelet: Wavelet, wrap: Wrap) -> None:
    """The plain torch version of unlift_level_shards, on any device: each
    shard's LL and chunk windows (row_window's pairs, the q heads first)
    assembled from the segments by indexing, unlift_level_rows_plain on
    them, its rows stored at their offset."""
    lvl = schedule.levels[k]
    C, T, tw = out.shape[0], lvl.target_h, lvl.target_w
    weff = wavelets.effective_wavelet(wavelet, tw, T)
    for p0, p1 in shards:
        win_lo, win_n = row_window(T, (p0, p1), weff, wrap)
        pairs = window_pairs(win_lo, win_n, T, wrap)
        llw = _window_of(ll_segs, pairs, 1)
        cbd = _window_of(cbd_segs, pairs, 2)
        cw = torch.cat([heads.view(C, 1), cbd.reshape(C, -1)], dim=1).reshape(-1)
        rows = unlift_level_rows_plain(llw, cw, schedule, k, (p0, p1), win_lo, wavelet, wrap)
        out[:, 2 * (p0 - out_p0) : 2 * (p0 - out_p0) + rows.shape[1]] = rows


def lift_level_shards(segs, schedule: LiftSchedule, k: int, shards, ll, chunk, out_p0: int,
                      wavelet: Wavelet, wrap: Wrap, qg) -> None:
    """K7 forward: one launch over `shards`, the non-empty pairs [p0, p1)
    of level k in order (at most MAX_SHARDS). Rows are read in place from
    `segs`, Segments of the level's (C, current_h, current_w) int16 plane
    (at most MAX_SEGS; the first that holds a row serves it), which must
    hold every row of each shard's window (row_window). Writes the shards'
    LL rows to ll, (C, out_len, target_w) contiguous int16 holding pairs
    [out_p0, out_p0 + out_len), and their gated, quantized C, B, D, with
    the q heads when a shard starts at out_p0, to chunk, (C * (1 + 3
    out_len target_w),) int16 in stream layout of those pairs (a level's
    chunk of the stream when out_p0 is 0 and out_len the level's pairs).
    One lift_level_shards launch, its region shards_region's."""
    lvl = schedule.levels[k]
    C, out_len, tw = ll.shape
    shards = tuple(tuple(p) for p in shards)
    _check_shards(schedule, k, shards, (segs,), out_p0, out_len, wavelet, wrap, False,
                  "lift_level_shards")
    _check_segs(segs, (C, lvl.current_w), ll.device, "lift_level_shards")
    _check(ll, (out_len, lvl.target_w), "lift_level_shards ll")
    if (chunk.dtype != torch.int16 or tuple(chunk.shape) != (C * (1 + 3 * out_len * tw),)
            or not chunk.is_contiguous() or chunk.device != ll.device):
        raise ValueError(f"lift_level_shards: expected a contiguous int16 chunk of "
                         f"{C * (1 + 3 * out_len * tw)} on {ll.device}, got {chunk.dtype} "
                         f"{tuple(chunk.shape)} on {chunk.device}")
    if not _on_card(ll, "lift_level_shards"):
        return lift_level_shards_plain(segs, schedule, k, shards, ll, chunk, out_p0, wavelet, wrap,
                                       qg)
    args = _k7_args(schedule, k, C, wavelet, wrap, tuple(qg),
                    shards_region(schedule, k, C, wavelet, shards, sm_count(ll.device)))
    table = _shard_table(shards, (segs,), out_p0, out_len)
    with torch.cuda.device(ll.device):
        kernels.lift_level_shards(args, table, chunk.data_ptr(), ll.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    kernels.count_launch(LAUNCHES, "lift_level_shards")


def unlift_level_shards(ll_segs, cbd_segs, heads, schedule: LiftSchedule, k: int, shards, out,
                        out_p0: int, wavelet: Wavelet, wrap: Wrap) -> None:
    """K7 inverse: one launch over `shards` (as lift_level_shards). The LL
    rows of level k by pair from `ll_segs`, Segments of its (C, target_h,
    target_w) int16 LL, its C, B, D rows by pair from `cbd_segs`, Segments
    of its (C, 3, target_h, target_w) quadrants (a level's chunk of the
    stream: cv[:, 1:].view(C, 3, T, tw)), each table holding every pair of
    each shard's window; the q heads are `heads`, (C,) int16 (any
    stride); each shard's C, B, D are dequantized by them as they load.
    Writes the shards' plane rows [2 p0, min(2 p1, current_h)) to out,
    (C, out_len, current_w) contiguous int16 holding rows [2 out_p0, 2
    out_p0 + out_len). One unlift_level_shards launch."""
    lvl = schedule.levels[k]
    C, out_len = out.shape[0], out.shape[1]
    shards = tuple(tuple(p) for p in shards)
    _check_shards(schedule, k, shards, (ll_segs, cbd_segs), out_p0, out_len, wavelet, wrap, True,
                  "unlift_level_shards")
    _check_segs(ll_segs, (C, lvl.target_w), out.device, "unlift_level_shards")
    _check_segs(cbd_segs, (C, 3, lvl.target_w), out.device, "unlift_level_shards")
    _check(out, (out_len, lvl.current_w), "unlift_level_shards out")
    if heads.dtype != torch.int16 or tuple(heads.shape) != (C,) or heads.device != out.device:
        raise ValueError(f"unlift_level_shards: expected int16 ({C},) q heads on {out.device}, "
                         f"got {heads.dtype} {tuple(heads.shape)} on {heads.device}")
    if not _on_card(out, "unlift_level_shards"):
        return unlift_level_shards_plain(ll_segs, cbd_segs, heads, schedule, k, shards, out, out_p0,
                                         wavelet, wrap)
    args = _k7_args(schedule, k, C, wavelet, wrap, None,
                    shards_region(schedule, k, C, wavelet, shards, sm_count(out.device)))
    table = _shard_table(shards, (ll_segs, cbd_segs), out_p0, out_len, heads)
    with torch.cuda.device(out.device):
        kernels.unlift_level_shards(args, table, out.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
    kernels.count_launch(LAUNCHES, "unlift_level_shards")


def _window_level(lvl, win_n: int) -> LiftLevel:
    """A window of win_n pairs of lvl's rows as a level of its own (even)
    height."""
    return LiftLevel(lvl.current_w, 2 * win_n, lvl.target_w, win_n)


def lift_level_rows_plain(win, schedule: LiftSchedule, k: int, pairs: tuple, win_lo: int,
                          wavelet: Wavelet, wrap: Wrap, qg):
    """The plain torch version of lift_level_rows, on any device: the
    pairs of row_window cut from the window and lifted as a level of
    their own height (wavelets.lift2d, the level's effective wavelet),
    gated and quantized, the shard's pairs kept. Exact: no tap of those
    pairs reaches the cut's own ends where they are not the line's."""
    lvl = schedule.levels[k]
    C = win.shape[0]
    weff = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
    # the window's end lies at the line's end where it is clipped there,
    # so the wrap rules of the lift apply where they do on the line
    lo, win_n = row_window(lvl.target_h, pairs, weff, wrap)
    win = win[:, 2 * (lo - win_lo) : 2 * (lo - win_lo + win_n)]
    ll, b, c, d = wavelets.lift2d(weff, wrap, win, _window_level(lvl, win_n))
    keep = slice(pairs[0] - lo, pairs[1] - lo)
    qs, gs = qg[k]
    q = torch.tensor(qs, dtype=torch.int32, device=win.device).view(C, 1, 1)
    g = torch.tensor(gs, dtype=torch.int32, device=win.device).view(C, 1, 1)
    parts = [i16(q.view(C, 1))] + [_quantize_gate(x[:, keep], q, g).reshape(C, -1)
                                   for x in (c, b, d)]
    return ll[:, keep].contiguous(), torch.cat(parts, dim=1).reshape(-1)


def unlift_level_rows_plain(ll, chunk, schedule: LiftSchedule, k: int, pairs: tuple, win_lo: int,
                            wavelet: Wavelet, wrap: Wrap):
    """The plain torch version of unlift_level_rows, on any device: the
    pairs of row_window cut from the windows, C, B, D dequantized by
    their q heads, unlifted as a level of their own height
    (wavelets.unlift2d), the shard's rows kept."""
    lvl = schedule.levels[k]
    C, n_in, tw = ll.shape
    weff = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
    lo, win_n = row_window(lvl.target_h, pairs, weff, wrap)
    keep = slice(lo - win_lo, lo - win_lo + win_n)
    quads = chunk.view(C, 1 + 3 * n_in * tw)
    q = i32(quads[:, :1]).view(C, 1, 1, 1)
    cbd = quads[:, 1:].reshape(C, 3, n_in, tw)[:, :, keep]
    cbd = torch.where(q > 1, i16(i32(cbd) * q), cbd)
    out = wavelets.unlift2d(weff, wrap, ll[:, keep], cbd[:, 1], cbd[:, 0], cbd[:, 2],
                            _window_level(lvl, win_n))
    r0 = 2 * (pairs[0] - lo)
    return out[:, r0 : r0 + min(2 * pairs[1], lvl.current_h) - 2 * pairs[0]].contiguous()


def lift_level_rows(win, schedule: LiftSchedule, k: int, pairs: tuple, win_lo: int,
                    wavelet: Wavelet, wrap: Wrap, qg):
    """K7 forward on one shard's window buffer: the pairs [p0, p1) of
    level k. win is the shard's (C, 2 win_n, current_w) int16 window, the
    level's rows of pairs [win_lo, win_lo + win_n), two rows a pair (an
    odd height's fake odd row stored as its even one), taken modulo the
    level's pairs for REPEAT; it must hold row_window's pairs. Returns
    (ll, out): the shard's (C, p1 - p0, target_w) LL, and its q heads and
    gated, quantized C, B, D in stream layout of its rows, (C * (1 + 3
    (p1 - p0) target_w),) int16. On the card one lift_level_shards launch
    of one shard, its segments row_window's pairs of the buffer
    (window_segments)."""
    lvl = schedule.levels[k]
    C, win_n = win.shape[0], win.shape[1] // 2
    _check_rows(schedule, k, pairs, win_lo, win_n, wavelet, wrap, "lift_level_rows")
    if not _on_card(win, "lift_level_rows"):
        return lift_level_rows_plain(win, schedule, k, pairs, win_lo, wavelet, wrap, qg)
    _check(win, (2 * win_n, lvl.current_w), "lift_level_rows")
    if win.dim() != 3 or win.shape[1] % 2:
        raise ValueError(f"lift_level_rows: expected (C, 2 win_n, w) rows, got {tuple(win.shape)}")
    rows = pairs[1] - pairs[0]
    ll = win.new_empty((C, rows, lvl.target_w))
    out = win.new_empty((C * (1 + 3 * rows * lvl.target_w),))
    weff = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
    lift_level_shards(window_segments(win, win_lo, lvl, pairs, weff, wrap, 2), schedule, k,
                      [pairs], ll, out, pairs[0], wavelet, wrap, qg)
    return ll, out


def unlift_level_rows(ll, chunk, schedule: LiftSchedule, k: int, pairs: tuple, win_lo: int,
                      wavelet: Wavelet, wrap: Wrap):
    """K7 inverse on one shard's window buffers: ll is the shard's (C,
    win_n, target_w) int16 LL window and chunk its (C * (1 + 3 win_n
    target_w),) chunk window in stream layout (each channel's q head, then
    its C, B, D rows), both of pairs [win_lo, win_lo + win_n) as
    lift_level_rows's window. Returns the plane's rows [2 p0, min(2 p1,
    current_h)), (C, rows, current_w) int16. On the card one
    unlift_level_shards launch of one shard."""
    lvl = schedule.levels[k]
    C, win_n, tw = ll.shape
    _check_rows(schedule, k, pairs, win_lo, win_n, wavelet, wrap, "unlift_level_rows")
    if not _on_card(ll, "unlift_level_rows"):
        return unlift_level_rows_plain(ll, chunk, schedule, k, pairs, win_lo, wavelet, wrap)
    _check(ll, (win_n, lvl.target_w), "unlift_level_rows ll")
    if (chunk.dtype != torch.int16 or tuple(chunk.shape) != (C * (1 + 3 * win_n * tw),)
            or not chunk.is_contiguous() or chunk.device != ll.device):
        raise ValueError(f"unlift_level_rows: expected a contiguous int16 chunk window of "
                         f"{C * (1 + 3 * win_n * tw)} on {ll.device}, got {chunk.dtype} "
                         f"{tuple(chunk.shape)} on {chunk.device}")
    out = ll.new_empty((C, min(2 * pairs[1], lvl.current_h) - 2 * pairs[0], lvl.current_w))
    cv = chunk.view(C, 1 + 3 * win_n * tw)
    weff = wavelets.effective_wavelet(wavelet, tw, lvl.target_h)
    unlift_level_shards(window_segments(ll, win_lo, lvl, pairs, weff, wrap, 1),
                        window_segments(cv[:, 1:].view(C, 3, win_n, tw), win_lo, lvl, pairs, weff,
                                        wrap, 1),
                        cv[:, 0], schedule, k, [pairs], out, pairs[0], wavelet, wrap)
    return out

"""One 2-D lift level per call, forward and inverse: the counterpart of
ako_tpu/ops/pallas_lift.py, in its two wirings.

- "fused" (default): one K1 (or K2) call per level, csrc/lift2d.cu
  ako_lift2d / ako_unlift2d.
- "split": three V-only K1v (or K2v) calls per level with torch
  transposes between them, wired as pallas_lift.py:167-172 and
  :242-247 (the H pass is transpose -> V-lift -> transpose).

The wiring is `mode`, read per call from AKO_TORCH_LIFT_MODE when not
given (the counterpart of AKO_TPU_PALLAS_MODE). A CUDA tensor launches
the hand-written Hopper kernels (built and bound by runtime/kernels.py);
if the build or the launch fails, the call raises. A CPU tensor takes
the plain torch version in ops/wavelets.py, through the same wiring,
and that is also what the kernels are checked against on the card.
Unlike the Pallas kernels, these take odd dimensions, so every level of
a tile goes through them.
"""

from __future__ import annotations

import math
import os

import torch

from ako_tpu_torch.core.settings import Wavelet, Wrap
from ako_tpu_torch.ops import wavelets
from ako_tpu_torch.runtime import kernels

#: kernel launches per wrapper (one per call that reaches the card)
LAUNCHES = {"lift2d": 0, "unlift2d": 0, "vlift": 0, "vunlift": 0}

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


def _t(x):
    return x.transpose(-1, -2).contiguous()


def lift2d_level(weff: Wavelet, wrap: Wrap, x, level, mode: str | None = None):
    """x: (..., current_h, current_w) int16 -> (ll, b, c, d), each
    (..., target_h, target_w) int16; what ops.wavelets.lift2d returns."""
    if lift_mode(mode) == "split":
        lp_t, hp_t = vlift_level(weff, wrap, _t(x))
        ll, c = vlift_level(weff, wrap, _t(lp_t))
        b, d = vlift_level(weff, wrap, _t(hp_t))
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
    LAUNCHES["lift2d"] += 1
    return ll, b, c, d


def unlift2d_level(weff: Wavelet, wrap: Wrap, ll, b, c, d, level, mode: str | None = None):
    """Quadrants (..., target_h, target_w) int16 -> plane (...,
    current_h, current_w) int16; what ops.wavelets.unlift2d returns."""
    if lift_mode(mode) == "split":
        left = vunlift_level(weff, wrap, ll, c, level.current_h)
        right = vunlift_level(weff, wrap, b, d, level.current_h)
        return _t(vunlift_level(weff, wrap, _t(left), _t(right), level.current_w))
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
    LAUNCHES["unlift2d"] += 1
    return out


def vlift_level(wavelet: Wavelet, wrap: Wrap, x):
    """x: (..., h, w) int16 -> (lp, hp), each (..., ceil(h/2), w) int16;
    what ops.wavelets.vlift returns."""
    if not _on_card(x, "vlift_level"):
        return wavelets.vlift(wavelet, wrap, x)
    h, w = x.shape[-2:]
    _check(x, (h, w), "vlift_level")
    lp, hp = (x.new_empty(x.shape[:-2] + ((h + 1) // 2, w)) for _ in range(2))
    with torch.cuda.device(x.device):
        kernels.vlift(
            x.data_ptr(), lp.data_ptr(), hp.data_ptr(), math.prod(x.shape[:-2]), h, w,
            int(wavelet), int(wrap), torch.cuda.current_stream().cuda_stream,
        )
    LAUNCHES["vlift"] += 1
    return lp, hp


def vunlift_level(wavelet: Wavelet, wrap: Wrap, lp, hp, out_h: int):
    """lp, hp (..., th, w) int16 -> (..., out_h, w) int16, out_h = 2*th
    or 2*th - 1; what ops.wavelets.vunlift returns."""
    if not _on_card(lp, "vunlift_level"):
        return wavelets.vunlift(wavelet, wrap, lp, hp, out_h)
    th, w = lp.shape[-2:]
    _check(lp, (th, w), "vunlift_level lp")
    _check(hp, (th, w), "vunlift_level hp")
    if hp.device != lp.device or hp.shape != lp.shape:
        raise ValueError("vunlift_level: hp does not match lp")
    if out_h not in (2 * th - 1, 2 * th):
        raise ValueError(f"vunlift_level: out_h {out_h} does not fit {th} rows")
    out = lp.new_empty(lp.shape[:-2] + (out_h, w))
    with torch.cuda.device(lp.device):
        kernels.vunlift(
            lp.data_ptr(), hp.data_ptr(), out.data_ptr(), math.prod(lp.shape[:-2]), th, w,
            out_h, int(wavelet), int(wrap), torch.cuda.current_stream().cuda_stream,
        )
    LAUNCHES["vunlift"] += 1
    return out

"""One 2-D lift level per call, forward and inverse: the counterpart of
ako_tpu/ops/pallas_lift.py.

A CUDA tensor launches the hand-written Hopper kernels of
csrc/lift2d.cu (built and bound by runtime/kernels.py); if the build
or the launch fails, the call raises. A CPU tensor takes the plain
torch version in ops/wavelets.py, which is also what the kernels are
checked against on the card. Unlike the Pallas kernels, these take odd
dimensions, so every level of a tile goes through them.
"""

from __future__ import annotations

import math

import torch

from ako_tpu_torch.core.settings import Wavelet, Wrap
from ako_tpu_torch.ops import wavelets
from ako_tpu_torch.runtime import kernels

#: kernel launches per wrapper (one per call that reaches the card)
LAUNCHES = {"lift2d": 0, "unlift2d": 0}


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


def lift2d_level(weff: Wavelet, wrap: Wrap, x, level):
    """x: (..., current_h, current_w) int16 -> (ll, b, c, d), each
    (..., target_h, target_w) int16; what ops.wavelets.lift2d returns."""
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


def unlift2d_level(weff: Wavelet, wrap: Wrap, ll, b, c, d, level):
    """Quadrants (..., target_h, target_w) int16 -> plane (...,
    current_h, current_w) int16; what ops.wavelets.unlift2d returns."""
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

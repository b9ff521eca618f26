"""Per-level quantization / noise-gate scalars.

The curve (library/quantization.c:43-97) is float32 over libm
sqrtf/log2f/powf/roundf; it is evaluated in the native runtime with the
very same libm for bit-exact parity, then cached here — inputs are few
and discrete (one (q, g) pair per tile-shape x level x channel-class).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

from ako_tpu_torch.core.geometry import LiftSchedule
from ako_tpu_torch.runtime.build import load


@functools.lru_cache(maxsize=65536)
def quantization(
    factor: int, factor_mul: int, tile_w: int, tile_h: int, cur_w: int, cur_h: int
) -> int:
    return int(load().akort_quantization(factor, factor_mul, tile_w, tile_h, cur_w, cur_h))


@functools.lru_cache(maxsize=65536)
def gate(
    factor: int, factor_mul: int, tile_w: int, tile_h: int, cur_w: int, cur_h: int
) -> int:
    return int(load().akort_gate(factor, factor_mul, tile_w, tile_h, cur_w, cur_h))


def level_qg(
    schedule: LiftSchedule,
    channels: int,
    quantization_factor: int,
    gate_factor: int,
    chroma_loss: int,
) -> List[Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """Per encode-order level: ((q per channel), (g per channel)).
    Channel 0 is luma (factor_mul 1); every other channel gets
    chroma_loss + 1 (library/lifting.c:199-211)."""
    out = []
    for lvl in schedule.levels:
        args = [
            (1 if ch == 0 else chroma_loss + 1, schedule.tile_w, schedule.tile_h,
             lvl.current_w, lvl.current_h)
            for ch in range(channels)
        ]
        qs = tuple(quantization(quantization_factor, *a) for a in args)
        gs = tuple(gate(gate_factor, *a) for a in args)
        out.append((qs, gs))
    return out

"""Tile geometry and dyadic lift scheduling — pure host-side math.

Everything here is derived from image/tile dimensions alone; the
container carries no per-level metadata (parity: library/misc.c:98-226
and the stream walk contract of library/misc.c:229-288). Same rules as
ako_tpu/core/geometry.py, copied because importing ako_tpu imports JAX.
Per distinct tile shape there is exactly one lift schedule, and the
device stage runs once per shape group.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

LIFT_HEAD_BYTES = 2  # one int16 quantization per (level, channel)
COEFF_BYTES = 2  # int16 coefficients end-to-end


def divide_plus_one(v: int) -> int:
    """Ceil-half used for odd lift dimensions (library/misc.c:98-101)."""
    return v // 2 if v % 2 == 0 else (v + 1) // 2


def planes_spacing(tile_w: int, tile_h: int) -> int:
    """Scratch gap between channel planes, in elements (library/misc.c:104-107).

    Only meaningful for the reference's in-place memory choreography,
    but it leaks into the wire-level error behavior of the entropy
    decoder's output bound, so we keep it.
    """
    return tile_w * 2 + tile_h * 2


def tile_data_size(tile_w: int, tile_h: int) -> int:
    """Exact serialized size in bytes of one channel's lift pyramid
    (library/misc.c:117-149): per level, three highpass quadrants plus a
    2-byte lift head; then the final lowpass plane."""
    size = 0
    w, h = tile_w, tile_h
    while w > 2 and h > 2:
        w = divide_plus_one(w)
        h = divide_plus_one(h)
        size += (w * h) * COEFF_BYTES * 3
        size += LIFT_HEAD_BYTES
    size += (w * h) * COEFF_BYTES
    return size


def tile_dimension(tile_pos: int, image_d: int, tiles_dimension: int) -> int:
    """Width/height of the tile starting at pixel `tile_pos`
    (library/misc.c:152-161): border tiles are remainders."""
    if tiles_dimension == 0:
        return image_d
    if tile_pos + tiles_dimension > image_d:
        return image_d % tiles_dimension
    return tiles_dimension


@dataclasses.dataclass(frozen=True)
class LiftLevel:
    """One dyadic lift step, encode orientation (current -> target)."""

    current_w: int
    current_h: int
    target_w: int
    target_h: int

    @property
    def fake_last_col(self) -> int:
        # 1 when current_w is odd: the lift fabricates a trailing column
        return self.target_w * 2 - self.current_w

    @property
    def fake_last_row(self) -> int:
        return self.target_h * 2 - self.current_h


@dataclasses.dataclass(frozen=True)
class LiftSchedule:
    """Static schedule for one tile shape.

    `levels[0]` is the full-resolution (first-executed) lift on encode;
    the serialized stream stores levels in reverse (smallest first),
    see library/misc.c:229-288.
    """

    tile_w: int
    tile_h: int
    levels: Tuple[LiftLevel, ...]

    @property
    def lp_w(self) -> int:
        return self.levels[-1].target_w if self.levels else self.tile_w

    @property
    def lp_h(self) -> int:
        return self.levels[-1].target_h if self.levels else self.tile_h

    def coeff_count(self, channels: int) -> int:
        """Number of int16 elements in the serialized tile stream
        (lift heads included — they are int16-sized)."""
        return tile_data_size(self.tile_w, self.tile_h) * channels // COEFF_BYTES


@functools.lru_cache(maxsize=None)
def lift_schedule(tile_w: int, tile_h: int) -> LiftSchedule:
    """Dyadic halving via the plus-one rule until either dim <= 2
    (encode loop structure of library/lifting.c:182-188)."""
    levels: List[LiftLevel] = []
    w, h = tile_w, tile_h
    while w > 2 and h > 2:
        cw, ch = w, h
        w = divide_plus_one(w)
        h = divide_plus_one(h)
        levels.append(LiftLevel(cw, ch, w, h))
    return LiftSchedule(tile_w, tile_h, tuple(levels))


@dataclasses.dataclass(frozen=True)
class TilePlacement:
    index: int
    x: int  # pixel offset in image
    y: int
    w: int
    h: int


def tile_grid(image_w: int, image_h: int, tiles_dimension: int) -> List[TilePlacement]:
    """Row-major tile walk matching the encode/decode loops
    (library/encode.c:115-205, library/decode.c:128-217)."""
    if tiles_dimension == 0:
        return [TilePlacement(0, 0, 0, image_w, image_h)]
    out: List[TilePlacement] = []
    t = 0
    y = 0
    while y < image_h:
        x = 0
        while x < image_w:
            out.append(
                TilePlacement(
                    t,
                    x,
                    y,
                    tile_dimension(x, image_w, tiles_dimension),
                    tile_dimension(y, image_h, tiles_dimension),
                )
            )
            t += 1
            x += tiles_dimension
        y += tiles_dimension
    return out


def group_by_shape(grid: List[TilePlacement]) -> dict:
    """{(w, h): [tiles]} in first-seen order: the device stage's unit of
    work (one batched run per distinct tile shape)."""
    by_shape: dict = {}
    for t in grid:
        by_shape.setdefault((t.w, t.h), []).append(t)
    return by_shape

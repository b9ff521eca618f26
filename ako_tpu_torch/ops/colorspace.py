"""Pixel format + reversible color transforms as torch ops.

Forward: interleaved u8 tile (h, w, ch) -> planar int16 (ch, h, w) in
Yuv order, with optional discard-non-visible (zero color where alpha
is zero). Inverse: planar int16 -> saturated interleaved u8. Exact
integer behavior of library/format.c:30-311, including C's truncating
/2 on negatives and int16 wraparound on every intermediate store; the
same steps as ako_tpu/ops/colorspace.py.
"""

from __future__ import annotations

import torch

from ako_tpu_torch.core.settings import Color
from ako_tpu_torch.ops.intmath import div2, i16, i32

_YUV = (Color.YCOCG, Color.YCOCG_Q, Color.SUBTRACT_G)


def to_planar_yuv(tile_u8, color: Color, discard_non_visible: bool):
    """tile_u8: (..., h, w, channels) uint8 -> (..., channels, h, w) int16."""
    channels = tile_u8.shape[-1]
    planes = i16(tile_u8.movedim(-1, -3))  # (..., ch, h, w)

    # Discard-non-visible applies only to alpha-bearing 2/4-channel
    # images (format.c:74-81)
    if discard_non_visible and channels in (2, 4):
        alpha = planes[..., -1:, :, :]
        color_part = torch.where(alpha != 0, planes[..., :-1, :, :], 0)
        planes = torch.cat([color_part, alpha], dim=-3)

    if channels >= 3 and color in _YUV:
        r = i32(planes[..., 0, :, :])
        g = i32(planes[..., 1, :, :])
        b = i32(planes[..., 2, :, :])
        if color in (Color.YCOCG, Color.YCOCG_Q):
            co = i16(r - b)
            tmp = i16(b + div2(i32(co)))
            cg = i16(g - i32(tmp))
            y = i16(i32(tmp) + div2(i32(cg)))
            if color == Color.YCOCG_Q:
                # premultiply Y x2: extra precision under quantization
                y = i16(i32(y) * 2)
            first3 = torch.stack([y, co, cg], dim=-3)
        else:  # SUBTRACT_G
            first3 = torch.stack([i16(g), i16(r - g), i16(b - g)], dim=-3)
        planes = torch.cat([first3, planes[..., 3:, :, :]], dim=-3)

    return planes


def to_interleaved_u8(planes, color: Color, channels: int):
    """(..., channels, h, w) int16 -> (..., h, w, channels) uint8 with
    inverse color transform + saturation (format.c:244-311)."""
    if channels >= 3 and color in _YUV:
        y = i32(planes[..., 0, :, :])
        u = i32(planes[..., 1, :, :])
        v = i32(planes[..., 2, :, :])
        if color in (Color.YCOCG, Color.YCOCG_Q):
            if color == Color.YCOCG_Q:
                y = i32(i16(div2(y)))
            tmp = i32(i16(y - div2(v)))
            g = i32(i16(v + tmp))
            b = i32(i16(tmp - div2(u)))
            r = i32(i16(b + u))
        else:
            r = i32(i16(u + y))
            g = i32(i16(y))
            b = i32(i16(v + y))
        first3 = torch.stack([r, g, b], dim=-3)
        out32 = torch.cat([first3, i32(planes[..., 3:, :, :])], dim=-3)
    else:
        out32 = i32(planes)

    return out32.clamp(0, 255).to(torch.uint8).movedim(-3, -1)

"""Effort-preset PNG writer — the missing half of akodec's `-e` flag.

The reference akodec maps effort 1..10 onto lodepng ZLIB presets AND
per-row filter strategies (`ZLIB_PRESET[10 - effort]`,
`PNG_FILTER_PRESET[10 - effort]`, tools/akodec.cpp:44-68,213-214):
effort 1 stores rows unfiltered over an uncompressed deflate stream,
2..9 use the MINSUM filter heuristic over increasingly aggressive
zlib settings, and 10 brute-forces the filter per row. Pillow exposes
only `compress_level` — neither per-row filter strategy nor zlib
strategy — so this module writes the PNG container directly:
vectorized scanline filtering + `zlib` + chunk CRCs. Output is a
standard 8-bit PNG (greyscale / grey+alpha / RGB / RGBA), decoded
back by any reader; only the *file size* depends on effort, never the
pixels. ako_tpu/tools/pngout.py's code, copied because importing
ako_tpu imports JAX; tests/test_torch_tools.py holds its bytes to
ako_tpu's for every effort.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG color type

#: effort -> (zlib level, zlib strategy, filter mode). Mirrors the
#: reference's direction: 1 = stored + unfiltered, 10 = slowest/best.
#: zlib has no windowsize/nicematch knobs, so the 8 middle lodepng
#: presets map onto levels 1..8 with Z_FILTERED (the strategy built
#: for filtered scanline data).
def _preset(effort: int):
    effort = max(1, min(10, effort))
    if effort == 1:
        return 0, zlib.Z_DEFAULT_STRATEGY, "none"
    if effort == 10:
        return 9, zlib.Z_FILTERED, "brute"
    return effort - 1, zlib.Z_FILTERED, "minsum"


def _filter_rows(img: np.ndarray, bpp: int) -> np.ndarray:
    """All five PNG filters of every row at once. img is (h, w*ch)
    uint8 (scanline bytes), bpp the byte offset of the left neighbor;
    returns (5, h, w*ch) uint8 residuals."""
    h, rb = img.shape
    a = np.zeros_like(img)  # left neighbor (per byte, offset bpp)
    a[:, bpp:] = img[:, :-bpp]
    b = np.zeros_like(img)  # above
    b[1:] = img[:-1]
    c = np.zeros_like(img)  # upper-left
    c[1:, bpp:] = img[:-1, :-bpp]

    ai = a.astype(np.int16)
    bi = b.astype(np.int16)
    ci = c.astype(np.int16)
    out = np.empty((5, h, rb), np.uint8)
    out[0] = img
    out[1] = img - a  # sub (mod 256)
    out[2] = img - b  # up
    out[3] = img - ((ai + bi) // 2).astype(np.uint8)  # average
    # paeth
    p = ai + bi - ci
    pa, pb, pc = np.abs(p - ai), np.abs(p - bi), np.abs(p - ci)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    out[4] = img - pred
    return out


def _encode_idat(image: np.ndarray, effort: int) -> bytes:
    h, w, ch = image.shape
    level, strategy, mode = _preset(effort)
    rows = np.ascontiguousarray(image).reshape(h, w * ch)

    if mode == "none":
        ftypes = np.zeros(h, np.uint8)
        filtered = rows[None]
        pick = np.zeros(h, np.intp)
    else:
        # 8-bit samples: the left-neighbor offset is the channel count
        filtered = _filter_rows(rows, ch)
        if mode == "minsum":
            # lodepng LFS_MINSUM: minimize the sum of |signed residual|
            v = filtered.astype(np.int16)
            cost = np.where(v < 128, v, 256 - v).sum(axis=2)
            pick = cost.argmin(axis=0)
        else:  # brute force: smallest individually-compressed row
            sizes = np.empty((5, h), np.int64)
            for f in range(5):
                for r in range(h):
                    sizes[f, r] = len(
                        zlib.compress(filtered[f, r].tobytes(), 6)
                    )
            pick = sizes.argmin(axis=0)
        ftypes = pick.astype(np.uint8)

    scan = np.empty((h, 1 + w * ch), np.uint8)
    scan[:, 0] = ftypes
    scan[:, 1:] = filtered[pick, np.arange(h)]
    comp = zlib.compressobj(level=level, strategy=strategy)
    return comp.compress(scan.tobytes()) + comp.flush()


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (
        struct.pack(">I", len(payload))
        + tag
        + payload
        + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray, effort: int = 7) -> None:
    """Write an 8-bit PNG of (h, w, channels) uint8 pixels with the
    reference akodec's effort semantics."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, ch = image.shape
    if ch not in _COLOR_TYPE:
        raise ValueError(f"unsupported channel count {ch}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", _encode_idat(image.astype(np.uint8), effort)))
        f.write(_chunk(b"IEND", b""))

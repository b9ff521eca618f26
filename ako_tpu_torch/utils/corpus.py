"""Procedural photographic-content corpus.

Synthesized content with photograph-like wavelet statistics: broad
smooth regions (long Kagari runs), edges (sparse large coefficients)
and cross-channel structure.

`photo()` builds multi-octave value noise (fBm) with:
  - piecewise-smooth regions from a thresholded low-frequency field
    (sky/wall analogs -> long zero runs at q16),
  - edge content from region boundaries (sparse large coefficients),
  - correlated RGB from a shared luminance + two low-octave chroma
    fields (YCoCg-friendly, like real photos),
  - fine sensor grain.

Everything is deterministic from the seed. A numpy-only copy of
ako_tpu/utils/corpus.py (the machine with the card has no JAX);
`corpus(42, 1, 1280, 1024, 4)[0]` is the north-star image, 1024x1280
(w x h) RGBA.
"""

from __future__ import annotations

import numpy as np


def _upsample_bilinear(grid: np.ndarray, h: int, w: int) -> np.ndarray:
    """(gh, gw) -> (h, w) separable bilinear, edge-clamped."""
    gh, gw = grid.shape
    y = np.linspace(0, gh - 1, h, dtype=np.float32)
    x = np.linspace(0, gw - 1, w, dtype=np.float32)
    y0 = np.minimum(y.astype(np.int32), gh - 2)
    x0 = np.minimum(x.astype(np.int32), gw - 2)
    fy = (y - y0)[:, None].astype(np.float32)
    fx = (x - x0)[None, :].astype(np.float32)
    g = grid.astype(np.float32)
    a = g[y0][:, x0]
    b = g[y0][:, x0 + 1]
    c = g[y0 + 1][:, x0]
    d = g[y0 + 1][:, x0 + 1]
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx


def fbm(
    rng: np.random.Generator,
    h: int,
    w: int,
    octaves: int = 7,
    gain: float = 0.55,
    base_cells: int = 4,
) -> np.ndarray:
    """Fractal value noise in [-1, 1]-ish, (h, w) float32."""
    acc = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        cells = base_cells * (1 << o)
        if cells >= max(h, w):
            break
        g = rng.normal(0, 1, size=(cells + 1, cells + 1)).astype(np.float32)
        acc += amp * _upsample_bilinear(g, h, w)
        total += amp
        amp *= gain
    return acc / max(total, 1e-6)


def photo(rng: np.random.Generator, h: int, w: int, ch: int = 4) -> np.ndarray:
    """One photographic-statistics uint8 image (h, w, ch)."""
    lum = fbm(rng, h, w, octaves=8)
    regions = fbm(rng, h, w, octaves=4, base_cells=2)
    # piecewise-constant region shifts: quantize the low-freq field
    levels = np.round(regions * 3.0).astype(np.float32) / 3.0
    chroma_a = fbm(rng, h, w, octaves=4)
    chroma_b = fbm(rng, h, w, octaves=4)

    y = 128 + 70 * lum + 45 * levels
    r = y + 40 * chroma_a
    g = y - 10 * chroma_a + 12 * chroma_b
    b = y - 35 * chroma_b

    img = np.stack([r, g, b, np.full_like(y, 255.0)][:ch], axis=-1)
    # sensor grain on the color channels only
    grain = rng.normal(0, 1.6, size=img.shape).astype(np.float32)
    if ch in (2, 4):
        grain[..., -1] = 0.0
    img = img + grain
    return np.clip(img, 0, 255).astype(np.uint8)


def corpus(
    seed: int, n: int, h: int, w: int, ch: int = 4
) -> list[np.ndarray]:
    """n deterministic images; each image gets an independent
    substream so corpus(n=12)[:6] == corpus(n=6)."""
    return [
        photo(np.random.default_rng([seed, k]), h, w, ch) for k in range(n)
    ]

"""The cell's images, made on the device from the seed.

A torch copy of the port's corpus arithmetic (ako_tpu_torch/utils/corpus.py
`photo`: multi-octave value noise for luminance, a thresholded
low-frequency field for flat regions and their edges, two chroma fields,
sensor grain), which runs in a fraction of a second on the card where
the numpy original takes seconds at the tractor's size. Each image's
grain takes its own sigma, as a photo set's ISO varies, and so its coded
size and run lengths; every seed gets the same set of sigmas, evenly
spread over the configuration's range, in an order drawn from the seed,
so that seeds change the content and not the amount of work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _fbm(gen, h: int, w: int, octaves: int, device, gain: float = 0.55,
         base_cells: int = 4):
    acc = torch.zeros((h, w), dtype=torch.float32, device=device)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        cells = base_cells << o
        if cells >= max(h, w):
            break
        g = torch.randn((1, 1, cells + 1, cells + 1), generator=gen, device=device)
        acc += amp * F.interpolate(g, size=(h, w), mode="bilinear", align_corners=True)[0, 0]
        total += amp
        amp *= gain
    return acc / max(total, 1e-6)


def photo(gen, h: int, w: int, channels: int, sigma: float, device):
    """One (h, w, channels) uint8 image on `device`."""
    lum = _fbm(gen, h, w, 8, device)
    regions = _fbm(gen, h, w, 4, device, base_cells=2)
    levels = torch.round(regions * 3.0) / 3.0
    chroma_a = _fbm(gen, h, w, 4, device)
    chroma_b = _fbm(gen, h, w, 4, device)
    y = 128 + 70 * lum + 45 * levels
    planes = [y + 40 * chroma_a, y - 10 * chroma_a + 12 * chroma_b, y - 35 * chroma_b,
              torch.full_like(y, 255.0)][:channels]
    img = torch.stack(planes, -1)
    grain = torch.randn(img.shape, generator=gen, device=device) * sigma
    if channels in (2, 4):
        grain[..., -1] = 0.0
    return (img + grain).clamp(0, 255).to(torch.uint8)


def sigmas(config: dict, seed: int) -> list:
    """The pool's grain sigmas: evenly over the configuration's range, in
    an order drawn from the seed."""
    lo, hi = config["grain_sigma"]
    n = config["pool_images"]
    order = np.random.default_rng(seed % 2**63).permutation(n)
    return [float(lo + (hi - lo) * k / max(n - 1, 1)) for k in order]


def make_pool(config: dict, seed: int, device) -> list:
    """The configuration's pool of images as host uint8 arrays (h, w, c),
    made on `device` and copied to the host once, into pinned memory when
    the device is a card."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    h, w, c = config["height"], config["width"], config["channels"]
    imgs = torch.stack([photo(gen, h, w, c, s, device) for s in sigmas(config, seed)])
    host = torch.empty(imgs.shape, dtype=torch.uint8, pin_memory=device.type == "cuda")
    host.copy_(imgs)
    return [host[i].numpy() for i in range(len(host))]

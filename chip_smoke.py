#!/usr/bin/env python3
"""Smoke run of ako_tpu_torch on one CUDA card: the quickest proof that
the port builds, runs its main path through its own kernels, and gives
the exact bytes and pixels.

    python3 chip_smoke.py

Phases, each raising on failure (so the run exits non-zero and prints
no result line):
  1. device   - a CUDA card is present; print its name and power limit
  2. build    - nvcc builds csrc/lift2d.cu, cc builds akort.c
  3. kernels  - the lift kernels equal their plain torch versions bit
                for bit: every wavelet x wrap, 80x4 planes of 128x128,
                odd 127x97 and 5x9, one 1024x1280 (w x h) plane
  4. goldens  - tests/golden blobs and pixels are reproduced exactly
  5. north    - the north-star image (fbm corpus, seed 42, 1024x1280
                RGBA) through encode/decode at 128-px tiles and at the
                default whole-image tile: blobs byte-equal and pixels
                bit-equal to the one-call native tile codec
                (runtime/hostcodec.py), and a lossless q=0 roundtrip
  6. launches - the main path launched each kernel once per level and
                shape group
  7. timings  - encode/decode ms and MP/s, per-stage host times, and
                per-level kernel time against the plain torch version

The second-to-last stdout line is the card's name and power limit from
nvidia-smi, before it a JSON line with each kernel's launches, error
and times; the last line is the JSON result.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
NORTH_STAR = dict(seed=42, h=1280, w=1024, ch=4)  # 1024x1280 (w x h) RGBA
RUNS = 7  # timed runs per measurement, after one warm-up
KERNEL_ITERS = 20


def log(*args) -> None:
    print(*args, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def north_star_settings(P):
    return {
        "north_t128": P.Settings(quantization=16, tiles_dimension=128),
        "default_whole": P.Settings(),
        "lossless_t128": P.Settings(quantization=0, gate=0, tiles_dimension=128),
    }


# ---------------------------------------------------------------- phases


def phase_build():
    from ako_tpu_torch.runtime import build, kernels

    t = time.perf_counter()
    kernels.load()
    t_cuda = time.perf_counter() - t
    t = time.perf_counter()
    build.load()
    t_akort = time.perf_counter() - t
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", kernels.build_log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", kernels.build_log))
    log(f"build: nvcc lift2d.cu {t_cuda:.2f} s, cc akort.c {t_akort:.2f} s; "
        f"ptxas max registers {max(regs, default=0)}, spill stores {spills} B")


def _rand16(rng, shape, dev):
    return torch.from_numpy(rng.integers(-32768, 32768, size=shape).astype(np.int16)).to(dev)


def phase_kernels(dev, shapes) -> dict:
    """Each kernel against its plain version on the same inputs on the
    card; returns the largest absolute difference per kernel (must be 0)."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.ops import lift_kernels, wavelets
    from ako_tpu_torch.core.settings import Wavelet, Wrap

    rng = np.random.default_rng(0)
    err = {"lift2d": 0, "unlift2d": 0}
    for (n, h, w), wavelet, wrap in itertools.product(
        shapes, [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR], list(Wrap)
    ):
        lvl = geometry.lift_schedule(w, h).levels[0]
        weff = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        x = _rand16(rng, (n, h, w), dev)
        got = lift_kernels.lift2d_level(weff, wrap, x, lvl)
        ref = wavelets.lift2d(weff, wrap, x, lvl)
        quads = [_rand16(rng, (n, lvl.target_h, lvl.target_w), dev) for _ in range(4)]
        got_inv = lift_kernels.unlift2d_level(weff, wrap, *quads, lvl)
        ref_inv = wavelets.unlift2d(weff, wrap, *quads, lvl)
        e_fwd = max(int((g.int() - r.int()).abs().max()) for g, r in zip(got, ref))
        e_inv = int((got_inv.int() - ref_inv.int()).abs().max())
        err["lift2d"] = max(err["lift2d"], e_fwd)
        err["unlift2d"] = max(err["unlift2d"], e_inv)
        if e_fwd or e_inv:
            raise AssertionError(
                f"kernel != plain for {weff.name} {wrap.name} {(n, h, w)}: "
                f"lift2d {e_fwd}, unlift2d {e_inv}"
            )
    log(f"kernels: equal to plain on {len(shapes)} shapes x 3 wavelets x 4 wraps")
    return err


def phase_goldens(P, dev):
    img = np.load(os.path.join(GOLDEN, "image_40x48_rgb.npy"))
    cases = {
        "q16": P.Settings(quantization=16),
        "lossless": P.Settings(quantization=0, gate=0),
        "tiled_q16": P.Settings(quantization=16, tiles_dimension=16),
    }
    for name, s in cases.items():
        with open(os.path.join(GOLDEN, f"{name}.ako"), "rb") as f:
            golden = f.read()
        if P.encode(img, s, device=dev) != golden:
            raise AssertionError(f"golden {name}: blob differs")
        pix, _, _ = P.decode(golden, device=dev)
        if not np.array_equal(pix, np.load(os.path.join(GOLDEN, f"{name}_decoded.npy"))):
            raise AssertionError(f"golden {name}: pixels differ")
    log(f"goldens: {len(cases)} blobs and pixels equal")


def oracle_encode(img, s):
    """Blob from the one-call native tile codec, framed as encode frames."""
    from ako_tpu_torch.core import container, geometry
    from ako_tpu_torch.encode import checked_settings, tile_qg, tile_stream_bytes
    from ako_tpu_torch.runtime.hostcodec import tile_encode_block
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD

    s = checked_settings(s)
    h, w, ch = img.shape
    blocks = [container.head_write(ch, w, h, s)]
    for t in geometry.tile_grid(w, h, s.tiles_dimension):
        qg = tile_qg(t.w, t.h, ch, s.quantization, s.gate, s.chroma_loss)
        payload = tile_encode_block(
            img[t.y : t.y + t.h, t.x : t.x + t.w], s.wavelet, s.wrap, s.color, qg,
            tile_stream_bytes(t, s, ch) - BLOCK_HEAD.size, bool(s.discard_non_visible),
        )
        if payload is None:
            raise AssertionError("oracle: incompressible tile")
        blocks.append(BLOCK_HEAD.pack(len(payload)) + payload)
    return b"".join(blocks)


def oracle_decode(blob):
    from ako_tpu_torch.core import container, geometry
    from ako_tpu_torch.decode import tile_block_sizes
    from ako_tpu_torch.runtime.hostcodec import tile_decode_block
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD

    view = memoryview(blob)
    ch, w, h, s = container.head_read(view)
    image = np.empty((h, w, ch), np.uint8)
    cursor = container.HEAD_SIZE
    for t in geometry.tile_grid(w, h, s.tiles_dimension):
        (size,) = BLOCK_HEAD.unpack_from(view, cursor)
        payload = view[cursor + BLOCK_HEAD.size : cursor + BLOCK_HEAD.size + size]
        cursor += BLOCK_HEAD.size + size
        tds, spacing = tile_block_sizes(t, s, ch)
        pix = tile_decode_block(
            payload, tds // 2, tds + spacing, t.w, t.h, ch, s.wavelet, s.wrap, s.color
        )
        if pix is None:
            raise AssertionError("oracle: broken block")
        image[t.y : t.y + t.h, t.x : t.x + t.w] = pix
    return image


def expected_launches(img, settings) -> int:
    """Lift levels over all shape groups: one kernel call each."""
    from ako_tpu_torch.core import geometry

    h, w, _ = img.shape
    grid = geometry.tile_grid(w, h, settings.tiles_dimension)
    return sum(
        len(geometry.lift_schedule(tw, th).levels) for tw, th in geometry.group_by_shape(grid)
    )


def phase_north_star(P, dev, img) -> dict:
    """Drive the main path (encode + decode under each setting) with
    the launch counts reset just before and read just after; then hold
    every blob and image to the native oracle."""
    from ako_tpu_torch.ops import lift_kernels

    settings = north_star_settings(P)
    for k in lift_kernels.LAUNCHES:
        lift_kernels.LAUNCHES[k] = 0
    results = {}
    for name, s in settings.items():
        blob = P.encode(img, s, device=dev)
        results[name] = (blob, P.decode(blob, device=dev)[0])
    launches = dict(lift_kernels.LAUNCHES)

    for name, s in settings.items():
        blob, pix = results[name]
        if blob != oracle_encode(img, s):
            raise AssertionError(f"{name}: blob differs from the native oracle")
        if not np.array_equal(pix, oracle_decode(blob)):
            raise AssertionError(f"{name}: pixels differ from the native oracle")
        log(f"north star {name}: {len(blob)} B (ratio {img.nbytes / len(blob):.3f}), "
            "blob and pixels equal to the native oracle")
    if not np.array_equal(results["lossless_t128"][1], img):
        raise AssertionError("lossless q=0 roundtrip differs from the input")

    want = sum(expected_launches(img, s) for s in settings.values())
    if launches != {"lift2d": want, "unlift2d": want}:
        raise AssertionError(f"launch counts {launches}, expected {want} each")
    log(f"launches: {launches} (expected {want} each = levels x shape groups)")
    return launches


def _median_ms(fn) -> float:
    fn()
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _stage_ms(call) -> dict:
    """Host-clock ms per event stage of one call (FORMAT/WAVELET/COMPRESSION)."""
    from ako_tpu_torch.core.events import Event

    acc: dict = {}
    start: dict = {}

    def cb(_tile, _total, event, _user):
        stage = Event(event).name.rsplit("_", 1)[0].lower()
        if Event(event).name.endswith("START"):
            start[stage] = time.perf_counter()
        else:
            acc[stage] = acc.get(stage, 0.0) + (time.perf_counter() - start[stage]) * 1e3

    call(cb)
    return {k: round(v, 3) for k, v in acc.items()}


def _event_ms(fn, iters=KERNEL_ITERS) -> float:
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_times(P, dev, img, s, card) -> dict:
    """Per-level kernel vs plain torch time (CUDA events) for the shape
    groups of one setting; returns per-kernel sums over the levels."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import checked_settings
    from ako_tpu_torch.ops import lift_kernels, wavelets

    s = checked_settings(s)
    h, w, ch = img.shape
    grid = geometry.tile_grid(w, h, s.tiles_dimension)
    rng = np.random.default_rng(1)
    total = {"lift2d": [0.0, 0.0], "unlift2d": [0.0, 0.0]}
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        for i, lvl in enumerate(geometry.lift_schedule(tw, th).levels):
            weff = wavelets.effective_wavelet(s.wavelet, lvl.target_w, lvl.target_h)
            n = len(tiles) * ch
            x = _rand16(rng, (n, lvl.current_h, lvl.current_w), dev)
            quads = [_rand16(rng, (n, lvl.target_h, lvl.target_w), dev) for _ in range(4)]
            row = {
                "lift2d": (
                    _event_ms(lambda: lift_kernels.lift2d_level(weff, s.wrap, x, lvl)),
                    _event_ms(lambda: wavelets.lift2d(weff, s.wrap, x, lvl)),
                ),
                "unlift2d": (
                    _event_ms(lambda: lift_kernels.unlift2d_level(weff, s.wrap, *quads, lvl)),
                    _event_ms(lambda: wavelets.unlift2d(weff, s.wrap, *quads, lvl)),
                ),
            }
            for k, (kern, plain) in row.items():
                total[k][0] += kern
                total[k][1] += plain
                log(f"  level {i} {k} {weff.name} n={n} {lvl.current_h}x{lvl.current_w}: "
                    f"kernel {kern:.4f} ms, plain {plain:.4f} ms [{card}]")
    return {k: (round(v[0], 4), round(v[1], 4)) for k, v in total.items()}


def phase_timings(P, dev, img, card) -> dict:
    mp = img.shape[0] * img.shape[1] / 1e6
    settings = north_star_settings(P)
    for name, s in settings.items():
        blob = P.encode(img, s, device=dev)
        enc = _median_ms(lambda: P.encode(img, s, device=dev))
        dec = _median_ms(lambda: P.decode(blob, device=dev))
        log(f"timing {name}: encode {enc:.2f} ms ({mp / enc * 1e3:.2f} MP/s), "
            f"decode {dec:.2f} ms ({mp / dec * 1e3:.2f} MP/s), "
            f"encode+decode {mp / (enc + dec) * 1e3:.2f} MP/s, median of {RUNS} [{card}]")
        log(f"  stages encode {_stage_ms(lambda cb: P.encode(img, s, cb, device=dev))} ms, "
            f"decode {_stage_ms(lambda cb: P.decode(blob, cb, device=dev))} ms (host clock)")
    per_kernel = {}
    for name in ("north_t128", "default_whole"):
        log(f"kernel times, {name} (sum over levels):")
        per_kernel[name] = kernel_times(P, dev, img, settings[name], card)
        log(f"  {name}: {per_kernel[name]} (kernel ms, plain ms)")
    return per_kernel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card", file=sys.stderr)
        return 2
    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")
    dev = torch.device("cuda:0")

    import ako_tpu_torch as P
    from ako_tpu_torch.utils.corpus import corpus

    phase_build()
    err = phase_kernels(dev, [(320, 128, 128), (3, 127, 97), (3, 5, 9), (1, 1280, 1024)])
    phase_goldens(P, dev)
    img = corpus(NORTH_STAR["seed"], 1, NORTH_STAR["h"], NORTH_STAR["w"], NORTH_STAR["ch"])[0]
    launches = phase_north_star(P, dev, img)
    times = phase_timings(P, dev, img, card)

    replaces = {"lift2d": "ako_tpu/ops/pallas_lift.py:90", "unlift2d": "ako_tpu/ops/pallas_lift.py:184"}
    kernels = [
        {
            "name": k,
            "route": "cuda",
            "source": "ako_tpu_torch/csrc/lift2d.cu",
            "replaces": replaces[k],
            "launches": launches[k],
            "max_abs_err": err[k],
            "ms": times["north_t128"][k][0],
            "plain_ms": times["north_t128"][k][1],
        }
        for k in ("lift2d", "unlift2d")
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

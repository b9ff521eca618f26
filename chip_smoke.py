#!/usr/bin/env python3
"""Smoke run of ako_tpu_torch on one CUDA card: the quickest proof that
the port builds, runs its main paths through its own kernels, and gives
the exact bytes and pixels.

    python3 chip_smoke.py

Phases, each raising on failure (so the run exits non-zero and prints
no result line):
  1. device   - a CUDA card is present; print its name and power limit
  2. build    - one nvcc call builds csrc/lift2d.cu and
                csrc/kagari_decode.cu, cc builds akort.c
  3. kernels  - every kernel equals its plain torch version bit for bit
                on the card: K1/K2 and K1v/K2v on every wavelet x wrap
                at the north star's 128-px level planes (and transposed
                planes), odd heights and one 1024x1280 (w x h) plane;
                K4 on the north star's streams and on edge streams
  4. goldens  - tests/golden blobs and pixels are reproduced exactly,
                on both entropy paths
  5. north    - the north-star image (fbm corpus, seed 42, 1024x1280
                RGBA) through encode/decode at 128-px tiles, at the
                default whole-image tile and lossless q=0: on the host
                entropy path, then on the device-entropy path in both
                lift wirings (fused, split). Blobs byte-equal and pixels
                bit-equal to the one-call native tile codec
                (runtime/hostcodec.py); no host fallback tile; each
                path's kernel launches counted from zero and exact
  6. profile  - torch.profiler over one warm north-star encode and
                decode on each path: device time per kernel, the torch
                ops of tokenize/pack, device busy and idle share
  7. timings  - encode/decode ms and MP/s, per-stage host times, and
                per-level kernel time against the plain torch version

The second-to-last stdout line is the card's name and power limit from
nvidia-smi, before it a JSON line with each kernel's launches, error,
times and bound; the last line is the JSON result.
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
KERNEL_ITERS = 50  # back-to-back launches per CUDA-event timing
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet),
#: taken as the peak of the kernels' 32-bit integer adds, shifts and compares
SCALAR_OPS_PER_S = 67e12
#: integer operations per sample of one 1-D DD 13/7 lift (predict: 4
#: taps, a multiply, the rounding shift and the add; update the same),
#: the costliest wavelet, so an upper count on CDF 5/3 levels
LIFT_OPS = 9
#: integer operations per value K4 decodes: the window shift and
#: refill, __clz, the gamma length and value, the unzigzag, the run
#: compare and counters
K4_OPS = 20
#: (path name, device_entropy, lift wiring)
PATHS = [("host", False, "fused"), ("device_fused", True, "fused"), ("device_split", True, "split")]
REPLACES = {
    "lift2d": "ako_tpu/ops/pallas_lift.py:90",
    "unlift2d": "ako_tpu/ops/pallas_lift.py:184",
    "vlift": "ako_tpu/ops/pallas_lift.py:127",
    "vunlift": "ako_tpu/ops/pallas_lift.py:211",
    "kagari_decode": "ako_tpu/ops/kagari_device.py:569",
}
SOURCES = {k: "ako_tpu_torch/csrc/lift2d.cu" for k in REPLACES}
SOURCES["kagari_decode"] = "ako_tpu_torch/csrc/kagari_decode.cu"
#: profiler kernel names -> kernel of the JSON line
DEVICE_KERNELS = {
    "lift_h": "lift2d", "lift_v": "lift2d", "unlift_v": "unlift2d", "unlift_h": "unlift2d",
    "vlift": "vlift", "vunlift": "vunlift", "kagari_decode": "kagari_decode",
}
#: a kernel's name in a profiler event, demangled ("ns::lift_h<0>(...)")
#: or mangled ("...6lift_hILi0E...")
KERNEL_RE = re.compile(r"(?:::|\d)(" + "|".join(DEVICE_KERNELS) + r")[<(IE]")


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


def all_launches() -> dict:
    from ako_tpu_torch.ops import kagari_device, lift_kernels

    return {**lift_kernels.LAUNCHES, **kagari_device.LAUNCHES}


def reset_launches() -> None:
    from ako_tpu_torch.ops import kagari_device, lift_kernels

    for counts in (lift_kernels.LAUNCHES, kagari_device.LAUNCHES):
        for k in counts:
            counts[k] = 0


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
    log(f"build: nvcc lift2d.cu + kagari_decode.cu {t_cuda:.2f} s, cc akort.c {t_akort:.2f} s; "
        f"ptxas max registers {max(regs, default=0)}, spill stores {spills} B")


def _rand16(rng, shape, dev):
    return torch.from_numpy(rng.integers(-32768, 32768, size=shape).astype(np.int16)).to(dev)


def _max_err(got, ref) -> int:
    return int((got.int() - ref.int()).abs().max())


def phase_lift_kernels(dev, shapes) -> dict:
    """K1/K2 against their plain versions on the same inputs on the
    card; returns the largest absolute difference per kernel (must be 0)."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.core.settings import Wavelet, Wrap
    from ako_tpu_torch.ops import lift_kernels, wavelets

    rng = np.random.default_rng(0)
    err = {"lift2d": 0, "unlift2d": 0}
    for (n, h, w), wavelet, wrap in itertools.product(
        shapes, [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR], list(Wrap)
    ):
        lvl = geometry.lift_schedule(w, h).levels[0]
        weff = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        x = _rand16(rng, (n, h, w), dev)
        got = lift_kernels.lift2d_level(weff, wrap, x, lvl, "fused")
        ref = wavelets.lift2d(weff, wrap, x, lvl)
        quads = [_rand16(rng, (n, lvl.target_h, lvl.target_w), dev) for _ in range(4)]
        got_inv = lift_kernels.unlift2d_level(weff, wrap, *quads, lvl, "fused")
        ref_inv = wavelets.unlift2d(weff, wrap, *quads, lvl)
        e_fwd = max(_max_err(g, r) for g, r in zip(got, ref))
        e_inv = _max_err(got_inv, ref_inv)
        err["lift2d"] = max(err["lift2d"], e_fwd)
        err["unlift2d"] = max(err["unlift2d"], e_inv)
        if e_fwd or e_inv:
            raise AssertionError(
                f"kernel != plain for {weff.name} {wrap.name} {(n, h, w)}: "
                f"lift2d {e_fwd}, unlift2d {e_inv}"
            )
    log(f"kernels: K1/K2 equal to plain on {len(shapes)} shapes x 3 wavelets x 4 wraps")
    return err


def vlift_shapes(img, tiles_dimension):
    """(n, h, w, level target or None) of the V-only calls: each 128-px
    level's plane transposed (the H pass) and its half-width planes
    (the V pass), then odd heights and one whole 1024x1280 plane."""
    from ako_tpu_torch.core import geometry

    h, w, ch = img.shape
    n = (h // tiles_dimension) * (w // tiles_dimension) * ch
    shapes = []
    for lvl in geometry.lift_schedule(tiles_dimension, tiles_dimension).levels:
        shapes.append((n, lvl.current_w, lvl.current_h, lvl))
        shapes.append((n, lvl.current_h, lvl.target_w, lvl))
    return shapes + [(3, 127, 97, None), (3, 5, 9, None), (1, 1280, 1024, None)]


def phase_vlift_kernels(dev, shapes) -> dict:
    """K1v/K2v against vlift/vunlift on the card, every wavelet x wrap
    (the level's effective wavelet on level shapes)."""
    from ako_tpu_torch.core.settings import Wavelet, Wrap
    from ako_tpu_torch.ops import lift_kernels, wavelets

    rng = np.random.default_rng(1)
    err = {"vlift": 0, "vunlift": 0}
    for (n, h, w, lvl), wavelet, wrap in itertools.product(
        shapes, [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR], list(Wrap)
    ):
        weff = wavelet if lvl is None else wavelets.effective_wavelet(
            wavelet, lvl.target_w, lvl.target_h)
        x = _rand16(rng, (n, h, w), dev)
        e_fwd = max(_max_err(g, r) for g, r in zip(
            lift_kernels.vlift_level(weff, wrap, x), wavelets.vlift(weff, wrap, x)))
        lp, hp = (_rand16(rng, (n, (h + 1) // 2, w), dev) for _ in range(2))
        e_inv = _max_err(lift_kernels.vunlift_level(weff, wrap, lp, hp, h),
                         wavelets.vunlift(weff, wrap, lp, hp, h))
        err["vlift"] = max(err["vlift"], e_fwd)
        err["vunlift"] = max(err["vunlift"], e_inv)
        if e_fwd or e_inv:
            raise AssertionError(f"K1v/K2v != plain for {weff.name} {wrap.name} {(n, h, w)}: "
                                 f"vlift {e_fwd}, vunlift {e_inv}")
    log(f"kernels: K1v/K2v equal to plain on {len(shapes)} shapes x 3 wavelets x 4 wraps")
    return err


def entropy_inputs(blob, dev):
    """Per shape group of a Kagari blob: the device decoder's upload
    (as decode.py builds it) on the card, with the group's output count
    and plain-version span."""
    from ako_tpu_torch.core import container, geometry
    from ako_tpu_torch.decode import pack_entropy_upload, split_entropy_upload, tile_block_sizes
    from ako_tpu_torch.ops.kagari_device import DECODE_BLOCK, decode_span_words
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD, kagari_sync

    view = memoryview(blob)
    ch, w, h, s = container.head_read(view)
    cursor = container.HEAD_SIZE
    groups: dict = {}
    for t in geometry.tile_grid(w, h, s.tiles_dimension):
        (size,) = BLOCK_HEAD.unpack_from(view, cursor)
        payload = view[cursor + BLOCK_HEAD.size : cursor + BLOCK_HEAD.size + size]
        cursor += BLOCK_HEAD.size + size
        tds, spacing = tile_block_sizes(t, s, ch)
        sync = kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK)
        if sync is None or sync[5] > 31:
            raise AssertionError("entropy inputs: a tile the device decoder does not take")
        groups.setdefault((t.w, t.h), []).append((t, payload, sync, tds // 2))
    out = []
    for items in groups.values():
        buf, T, B = pack_entropy_upload([it[:3] for it in items])
        span = max(decode_span_words(sy[0], len(p) * 8) for _, p, sy, _ in items)
        out.append((split_entropy_upload(torch.from_numpy(buf).to(dev), T, B), items[0][3], span))
    return out


def _edge_blob_inputs(v, dev):
    """K4 inputs for one edge stream (one tile, host-encoded)."""
    from ako_tpu_torch.decode import pack_entropy_upload, split_entropy_upload
    from ako_tpu_torch.ops.kagari_device import DECODE_BLOCK, decode_span_words
    from ako_tpu_torch.runtime.kagari import kagari_encode, kagari_sync

    v = np.asarray(v, np.int16)
    cap = v.size * 2 + 64
    payload = kagari_encode(v, cap * 4)
    sync = kagari_sync(v.size, payload, cap, DECODE_BLOCK)
    if payload is None or sync is None or sync[5] > 31:
        raise AssertionError("edge stream: not device-decodable")
    buf, T, B = pack_entropy_upload([(None, payload, sync)])
    span = decode_span_words(sync[0], len(payload) * 8)
    return split_entropy_upload(torch.from_numpy(buf).to(dev), T, B), v.size, span, v


def phase_k4(dev, north_blob) -> int:
    """K4 against the plain block decoder on the card: the north star's
    streams and edge streams (a run past the 65534 forced flush, the
    int16 extremes, runs across blocks)."""
    from ako_tpu_torch.ops import kagari_device as kd

    rng = np.random.default_rng(2)
    runs = rng.integers(-300, 300, size=20000)
    runs[rng.random(20000) < 0.6] = 0
    edges = [np.zeros(70000), np.full(1 + 2 * 65534 + 10, -2), np.array([32767] * 600 + [-32767] * 600),
             np.array([-32767, 32767, 0, -1, 1] * 300), runs, np.array([3, 3, 3]), np.array([7])]
    cases = [(parts, n, span, None) for parts, n, span in entropy_inputs(north_blob, dev)]
    cases += [_edge_blob_inputs(v, dev) for v in edges]
    err = 0
    for parts, n, span, want in cases:
        got = kd.kagari_decode_device(*parts, n)
        ref = kd._decode_plain(*parts, n, kd.DECODE_BLOCK, span)
        e = _max_err(got, ref)
        err = max(err, e)
        if e or (want is not None and not np.array_equal(got.cpu().numpy()[0], want)):
            raise AssertionError(f"K4 != plain (or the stream) on a {tuple(got.shape)} case: {e}")
    log(f"kernels: K4 equal to plain on the north star's streams and {len(edges)} edge streams")
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
        want = np.load(os.path.join(GOLDEN, f"{name}_decoded.npy"))
        for device_entropy in (False, True):
            if P.encode(img, s, device=dev, device_entropy=device_entropy) != golden:
                raise AssertionError(f"golden {name}: blob differs (device_entropy={device_entropy})")
            pix, _, _ = P.decode(golden, device=dev, device_entropy=device_entropy)
            if not np.array_equal(pix, want):
                raise AssertionError(f"golden {name}: pixels differ (device_entropy={device_entropy})")
    log(f"goldens: {len(cases)} blobs and pixels equal on both entropy paths")


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


def level_groups(img, settings):
    """(levels, shape groups) summed: lift levels over all shape groups,
    and the number of shape groups."""
    from ako_tpu_torch.core import geometry

    h, w, _ = img.shape
    groups = geometry.group_by_shape(geometry.tile_grid(w, h, settings.tiles_dimension))
    return sum(len(geometry.lift_schedule(tw, th).levels) for tw, th in groups), len(groups)


def expected_launches(img, settings, device_entropy: bool, mode: str) -> dict:
    """One K1 (K2) call per level and shape group, or three K1v (K2v) in
    split mode; one K4 per shape group of a device-entropy decode."""
    levels, groups = 0, 0
    for s in settings.values():
        lv, gr = level_groups(img, s)
        levels += lv
        groups += gr
    fused = levels if mode == "fused" else 0
    split = 3 * levels if mode == "split" else 0
    return {"lift2d": fused, "unlift2d": fused, "vlift": split, "vunlift": split,
            "kagari_decode": groups if device_entropy else 0}


def phase_north_star(P, dev, img, oracle) -> dict:
    """Drive each path (encode + decode under each setting) with the
    launch counts reset just before and read just after; then hold every
    blob and image to the native oracle, and the device-entropy paths to
    zero host fallbacks."""
    from ako_tpu_torch.utils import metrics

    settings = north_star_settings(P)
    launches = {}
    for path, device_entropy, mode in PATHS:
        os.environ["AKO_TORCH_LIFT_MODE"] = mode
        metrics.reset()
        reset_launches()
        results = {}
        for name, s in settings.items():
            blob = P.encode(img, s, device=dev, device_entropy=device_entropy)
            results[name] = (blob, P.decode(blob, device=dev, device_entropy=device_entropy)[0])
        launches[path] = all_launches()
        fallbacks = metrics.fallback_summary()

        for name in settings:
            blob, pix = results[name]
            want_blob, want_pix = oracle[name]
            if blob != want_blob:
                raise AssertionError(f"{path} {name}: blob differs from the native oracle")
            if not np.array_equal(pix, want_pix):
                raise AssertionError(f"{path} {name}: pixels differ from the native oracle")
            log(f"north star {path} {name}: {len(blob)} B (ratio {img.nbytes / len(blob):.3f}), "
                "blob and pixels equal to the native oracle")
        if not np.array_equal(results["lossless_t128"][1], img):
            raise AssertionError(f"{path}: lossless q=0 roundtrip differs from the input")

        want = expected_launches(img, settings, device_entropy, mode)
        if launches[path] != want:
            raise AssertionError(f"{path}: launch counts {launches[path]}, expected {want}")
        if device_entropy:
            from ako_tpu_torch.core import geometry

            tiles = sum(len(geometry.tile_grid(img.shape[1], img.shape[0], s.tiles_dimension))
                        for s in settings.values())
            want_fb = {metrics.ENC_DEVICE: tiles, metrics.ENC_HOST_FALLBACK: 0,
                       metrics.DEC_DEVICE: tiles, metrics.DEC_HOST_FALLBACK: 0}
            if fallbacks != want_fb:
                raise AssertionError(f"{path}: fallbacks {fallbacks}, expected {want_fb}")
        log(f"launches {path}: {launches[path]} (expected); fallbacks {fallbacks}")
    os.environ.pop("AKO_TORCH_LIFT_MODE")
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
    """Host-clock ms per event stage of one call (FORMAT/WAVELET/
    COMPRESSION), with the number of event pairs and the first pair's
    ms (the device-entropy decode's first COMPRESSION pair is the host
    block walk and sync scan)."""
    from ako_tpu_torch.core.events import Event

    acc: dict = {}
    start: dict = {}

    def cb(_tile, _total, event, _user):
        stage = Event(event).name.rsplit("_", 1)[0].lower()
        if Event(event).name.endswith("START"):
            start[stage] = time.perf_counter()
        else:
            acc.setdefault(stage, []).append((time.perf_counter() - start[stage]) * 1e3)

    call(cb)
    return {k: f"{sum(v):.3f} ({len(v)} pairs, first {v[0]:.3f})" for k, v in acc.items()}


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


def _profile_window(fn) -> dict:
    """One warm call under torch.profiler: host-clock wall ms, device
    busy ms (union of device intervals), and device ms per kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    per: dict = {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        m = KERNEL_RE.search(name)
        key = m.group(1) if m else ("memcpy" if "Memcpy" in name else "torch ops")
        per[key] = per.get(key, 0.0) + (b - a) / 1e3
    return {"wall": wall, "busy": busy / 1e3, "per": per, "events": len(spans)}


def phase_profile(P, dev, img, card) -> dict:
    """Device time per kernel on one warm north-star (128-px tiles)
    encode and decode on each path, and the tokenize/pack torch ops
    alone. Returns {kernel: device ms per image} from the path that
    runs it."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import checked_settings, forward_streams, pack_budget
    from ako_tpu_torch.ops.kagari_device import kagari_encode_device
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD

    s = north_star_settings(P)["north_t128"]
    per_kernel: dict = {}
    for path, device_entropy, mode in PATHS:
        os.environ["AKO_TORCH_LIFT_MODE"] = mode
        blob = P.encode(img, s, device=dev, device_entropy=device_entropy)
        for direction, fn in (
            ("encode", lambda: P.encode(img, s, device=dev, device_entropy=device_entropy)),
            ("decode", lambda: P.decode(blob, device=dev, device_entropy=device_entropy)),
        ):
            r = _profile_window(fn)
            if r["events"] == 0:
                log("profile: the profiler shows no device time; kernel ms come from CUDA "
                    f"events around {KERNEL_ITERS} back-to-back launches")
                return {}
            per = {k: round(v, 4) for k, v in sorted(r["per"].items())}
            log(f"profile {path} {direction}: wall {r['wall']:.3f} ms, device busy {r['busy']:.3f} ms "
                f"(idle {100 * (1 - r['busy'] / r['wall']):.1f}%); device ms {per} [{card}]")
            if device_entropy:
                for name, k in DEVICE_KERNELS.items():
                    if name in r["per"] and (mode == "split") == (k in ("vlift", "vunlift")):
                        per_kernel[k] = per_kernel.get(k, 0.0) + r["per"][name]
    os.environ.pop("AKO_TORCH_LIFT_MODE")

    # K3: the tokenize + pack torch ops on the north star's streams
    s = checked_settings(s)
    h, w, ch = img.shape
    tiles = geometry.tile_grid(w, h, s.tiles_dimension)
    batch = np.stack([img[t.y : t.y + t.h, t.x : t.x + t.w] for t in tiles])
    streams = forward_streams(torch.from_numpy(batch).to(dev), s.tiles_dimension,
                              s.tiles_dimension, ch, s)
    cap = streams.shape[1] * 2 - BLOCK_HEAD.size
    budget = pack_budget(cap, s.quantization)
    r = _profile_window(lambda: kagari_encode_device(streams, cap, budget))
    # bound: the int16 streams read once, the (T, budget) rows and the
    # totals written once
    comp, totals = kagari_encode_device(streams, cap, budget)
    bound = (streams.nbytes + comp.nbytes + totals.nbytes) / HBM_BYTES_PER_S * 1e3
    log(f"profile K3 tokenize+pack (torch ops) on {tuple(streams.shape)}: device busy "
        f"{r['busy']:.3f} ms of wall {r['wall']:.3f} ms, {r['events']} device events, "
        f"byte bound {bound:.5f} ms [{card}]")
    return {k: round(v, 4) for k, v in per_kernel.items()}


def _level_inputs(rng, dev, n, lvl):
    x = _rand16(rng, (n, lvl.current_h, lvl.current_w), dev)
    quads = [_rand16(rng, (n, lvl.target_h, lvl.target_w), dev) for _ in range(4)]
    return x, quads


def kernel_times(P, dev, img, s, card, split: bool) -> dict:
    """Per-level kernel vs plain torch time (CUDA events around
    back-to-back calls, so launch rate for the small levels) for the
    shape groups of one setting; returns per-kernel sums over levels."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import checked_settings
    from ako_tpu_torch.ops import lift_kernels, wavelets

    s = checked_settings(s)
    h, w, ch = img.shape
    grid = geometry.tile_grid(w, h, s.tiles_dimension)
    rng = np.random.default_rng(1)
    names = ("vlift", "vunlift") if split else ("lift2d", "unlift2d")
    total = {k: [0.0, 0.0] for k in names}
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        for i, lvl in enumerate(geometry.lift_schedule(tw, th).levels):
            weff = wavelets.effective_wavelet(s.wavelet, lvl.target_w, lvl.target_h)
            n = len(tiles) * ch
            x, quads = _level_inputs(rng, dev, n, lvl)
            if split:
                # the three V-only calls of a level, at their input shapes
                xs = [x.transpose(-1, -2).contiguous()] + [
                    _rand16(rng, (n, lvl.current_h, lvl.target_w), dev) for _ in range(2)]
                ls = [(quads[0], quads[2], lvl.current_h), (quads[1], quads[3], lvl.current_h),
                      (_rand16(rng, (n, lvl.target_w, lvl.current_h), dev),
                       _rand16(rng, (n, lvl.target_w, lvl.current_h), dev), lvl.current_w)]
                row = {
                    "vlift": (
                        _event_ms(lambda: [lift_kernels.vlift_level(weff, s.wrap, a) for a in xs]),
                        _event_ms(lambda: [wavelets.vlift(weff, s.wrap, a) for a in xs]),
                    ),
                    "vunlift": (
                        _event_ms(lambda: [lift_kernels.vunlift_level(weff, s.wrap, *a) for a in ls]),
                        _event_ms(lambda: [wavelets.vunlift(weff, s.wrap, *a) for a in ls]),
                    ),
                }
            else:
                row = {
                    "lift2d": (
                        _event_ms(lambda: lift_kernels.lift2d_level(weff, s.wrap, x, lvl, "fused")),
                        _event_ms(lambda: wavelets.lift2d(weff, s.wrap, x, lvl)),
                    ),
                    "unlift2d": (
                        _event_ms(lambda: lift_kernels.unlift2d_level(weff, s.wrap, *quads, lvl,
                                                                      "fused")),
                        _event_ms(lambda: wavelets.unlift2d(weff, s.wrap, *quads, lvl)),
                    ),
                }
            for k, (kern, plain) in row.items():
                total[k][0] += kern
                total[k][1] += plain
                log(f"  level {i} {k} {weff.name} n={n} {lvl.current_h}x{lvl.current_w}: "
                    f"kernel {kern:.4f} ms, plain {plain:.4f} ms [{card}]")
    return {k: (round(v[0], 4), round(v[1], 4)) for k, v in total.items()}


def k4_times(dev, blob, card) -> tuple:
    """K4 vs the plain block decoder on the card, summed over the north
    star's shape groups (CUDA events)."""
    from ako_tpu_torch.ops import kagari_device as kd

    kern = plain = 0.0
    for parts, n, span in entropy_inputs(blob, dev):
        kern += _event_ms(lambda: kd.kagari_decode_device(*parts, n))
        plain += _event_ms(lambda: kd._decode_plain(*parts, n, kd.DECODE_BLOCK, span), iters=3)
    log(f"  K4 per image: kernel {kern:.4f} ms (CUDA events, launch included), "
        f"plain {plain:.4f} ms [{card}]")
    return round(kern, 4), round(plain, 4)


def bounds_ms(img, blob) -> dict:
    """Least time per north-star image (128-px tiles) for each kernel:
    {kernel: (ms, "bytes" or "operations")}, the larger of the bytes it
    must move (each input read once, each output written once) over the
    card's memory rate and its integer operations over the 32-bit scalar
    rate."""
    from ako_tpu_torch.core import container, geometry
    from ako_tpu_torch.ops.kagari_device import DECODE_BLOCK
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD

    h, w, ch = img.shape
    t = 128
    n = (h // t) * (w // t) * ch
    b = {"lift2d": 0, "unlift2d": 0, "vlift": 0, "vunlift": 0}
    ops = dict(b)
    for lvl in geometry.lift_schedule(t, t).levels:
        plane = lvl.current_h * lvl.current_w
        b["lift2d"] += n * 2 * (plane + 4 * lvl.target_h * lvl.target_w)
        # three V-only calls: (w, h) -> 2x (w/2, h), then 2x (h, w/2) -> 4x (h/2, w/2)
        b["vlift"] += n * 2 * (plane + 2 * lvl.current_h * lvl.target_w) * 2
        # either wiring: one 1-D lift along each axis of the plane
        ops["lift2d"] += n * plane * 2 * LIFT_OPS
    b["unlift2d"], b["vunlift"] = b["lift2d"], b["vlift"]
    ops["unlift2d"] = ops["vlift"] = ops["vunlift"] = ops["lift2d"]
    # K4: the compressed payloads, the base words and the sync records
    # (four int32 each) in, the int16 streams out
    tiles = len(geometry.tile_grid(w, h, t))
    count = geometry.tile_data_size(t, t) * ch // 2
    payload = len(blob) - container.HEAD_SIZE - BLOCK_HEAD.size * tiles
    records = tiles * -(-count // DECODE_BLOCK)
    b["kagari_decode"] = payload + 4 * tiles + 16 * records + 2 * tiles * count
    ops["kagari_decode"] = tiles * count * K4_OPS
    out = {}
    for k in b:
        by_bytes, by_ops = b[k] / HBM_BYTES_PER_S * 1e3, ops[k] / SCALAR_OPS_PER_S * 1e3
        out[k] = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    return out


def phase_timings(P, dev, img, card) -> dict:
    mp = img.shape[0] * img.shape[1] / 1e6
    settings = north_star_settings(P)
    for (path, device_entropy, mode), (name, s) in itertools.product(PATHS, settings.items()):
        if mode == "split" and name != "north_t128":
            continue
        os.environ["AKO_TORCH_LIFT_MODE"] = mode
        blob = P.encode(img, s, device=dev, device_entropy=device_entropy)
        enc = _median_ms(lambda: P.encode(img, s, device=dev, device_entropy=device_entropy))
        dec = _median_ms(lambda: P.decode(blob, device=dev, device_entropy=device_entropy))
        log(f"timing {path} {name}: encode {enc:.2f} ms ({mp / enc * 1e3:.2f} MP/s), "
            f"decode {dec:.2f} ms ({mp / dec * 1e3:.2f} MP/s), "
            f"encode+decode {mp / (enc + dec) * 1e3:.2f} MP/s, median of {RUNS} [{card}]")
        stages_enc = _stage_ms(lambda cb: P.encode(img, s, cb, device=dev,
                                                   device_entropy=device_entropy))
        stages_dec = _stage_ms(lambda cb: P.decode(blob, cb, device=dev,
                                                   device_entropy=device_entropy))
        log(f"  stages encode {stages_enc} ms, decode {stages_dec} ms (host clock)")
    os.environ.pop("AKO_TORCH_LIFT_MODE")
    per_kernel = {}
    for name in ("north_t128", "default_whole"):
        log(f"kernel times, {name} (sum over levels):")
        per_kernel[name] = kernel_times(P, dev, img, settings[name], card, split=False)
        log(f"  {name}: {per_kernel[name]} (kernel ms, plain ms)")
    log("kernel times, north_t128 split wiring (sum over levels):")
    split = kernel_times(P, dev, img, settings["north_t128"], card, split=True)
    log(f"  north_t128 split: {split} (kernel ms, plain ms)")
    return {**per_kernel["north_t128"], **split}


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
    img = corpus(NORTH_STAR["seed"], 1, NORTH_STAR["h"], NORTH_STAR["w"], NORTH_STAR["ch"])[0]
    oracle = {}
    for name, s in north_star_settings(P).items():
        blob = oracle_encode(img, s)
        oracle[name] = (blob, oracle_decode(blob))

    err = phase_lift_kernels(dev, [(320, 128, 128), (3, 127, 97), (3, 5, 9), (1, 1280, 1024)])
    err.update(phase_vlift_kernels(dev, vlift_shapes(img, 128)))
    err["kagari_decode"] = phase_k4(dev, oracle["north_t128"][0])
    phase_goldens(P, dev)
    launches = phase_north_star(P, dev, img, oracle)
    device_ms = phase_profile(P, dev, img, card)
    times = phase_timings(P, dev, img, card)
    times["kagari_decode"] = k4_times(dev, oracle["north_t128"][0], card)
    bound = bounds_ms(img, oracle["north_t128"][0])
    for k in REPLACES:
        if k not in device_ms:  # no device time in the profile: CUDA events
            device_ms[k] = times[k][0]
            log(f"{k}: ms from CUDA events (kernel launch rate), not the profiler")

    # launches: lift2d/unlift2d/K4 on the fused device-entropy path,
    # vlift/vunlift on the split one
    path_of = {"vlift": "device_split", "vunlift": "device_split"}
    kernels = [
        {
            "name": k,
            "route": "cuda",
            "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": launches[path_of.get(k, "device_fused")][k],
            "max_abs_err": err[k],
            "ms": device_ms[k],
            "plain_ms": times[k][1],
            "bound_ms": round(bound[k][0], 5),
            "bound_by": bound[k][1],
            "library_ms": None,
        }
        for k in REPLACES
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

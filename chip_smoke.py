#!/usr/bin/env python3
"""Smoke run of ako_tpu_torch on one CUDA card: the quickest proof that
the port builds, runs its main paths through its own kernels, and gives
the exact bytes and pixels.

    python3 chip_smoke.py

Phases, each raising on failure (so the run exits non-zero and prints
no result line):
  1. device   - a CUDA card is present; print its name and power limit
  2. build    - one nvcc per source (csrc/lift2d.cu, vlift.cu,
                lift_pyramid.cu, lift_level.cu, kagari_encode.cu,
                kagari_decode.cu, manba_encode.cu, manba_decode.cu,
                rate.cu), all started together, then a link; cc builds
                the port's csrc/akort.c
  3. kernels  - every kernel equals its plain torch version bit for bit
                on the card: K1/K2 on every wavelet x wrap at the north
                star's 128-px level planes, odd heights and one
                1024x1280 (w x h) plane; K1v/K2v on every wavelet x wrap
                along both axes, one call and two calls a launch, at
                the split wiring's calls on the north star's 128-px
                levels, odd heights and widths, 1-px and 2-px sides, 4x4
                planes and the whole 1024x1280 plane;
                lift_pyramid / unlift_pyramid on every wavelet x wrap at
                the north star's tile group, odd and tiny tiles (every
                start level), tiles with fewer rows than channels,
                every colour, 1-4 channels, discard with zero alphas,
                and the whole tile's route from its start level, the
                inverse on random streams whose q heads are
                0, 1 and above 1 and whose dequantize wraps;
                lift_level / unlift_level on every wavelet x wrap at the
                whole tile's levels 0-2, 256-px tiles' level 0, odd
                sides, a 3x100000 tile (every level and the LP head),
                1, 2, 3, 4 and 9 channels, every colour and discard,
                small planes (a last region narrower than its halo,
                REPEAT's window wider than the line), rows loaded by
                cp.async and one sample at a time, the inverse on
                streams whose q heads wrap;
                K3 (bytes and totals) on the north star's 80 streams, the
                whole-image tile's 5.2 M-value stream, lossless q=0
                streams, edge streams (runs, forced flushes and -32768
                across its 4096-value chunks, the densest codes, an
                all-equal stream, a run of 70 chunks with a flush) and
                budgets that cut, calls of other shapes back to back on
                its reused scratch, and 100 repeated calls on the north
                star's streams; K4 on the north star's streams and on
                edge streams, on both its routes (spans staged in shared
                memory, and spans too wide for it that read the pool)
     k6       - K6e (the Manbavaran rANS encoder: record, rANS and extras
                bytes) and K6d (its block decoder) bit for bit against
                their plain versions on the card: the north star's 80
                streams at q=16 and lossless q=0, the kinds of
                tests/test_manbavaran.py (photo, zeros, full range,
                -32768, a single value, runs), streams through the chain
                step's cases (symbols of f = 1, a dominant symbol near
                f = 4096, two renorms beside none), a budget that cuts,
                and calls of other shapes back to back; both against the
                native coder (akort_manba_encode / akort_manba_decode)
                there too and on the whole tile's 5,242,932-value stream,
                where the plain chain (a torch loop over positions) is too
                slow and is skipped; K6d also on the edge cases of
                tests/test_torch_manba_tiles.py (k6d_edge_cases: zero
                frequencies at both ends, tiles of one block and of n not
                a multiple of 128, a CTA of one lane, rows not 16-byte
                aligned, a pool ending on the payload, records that run
                out of rANS bytes or point past the pool)
     rate     - K8s (rate_serialize) and K8p (rate_sizes), the rate
                search's kernels, bit for bit against their plain versions
                on the raw pyramids the search caches: the north star at
                128-px tiles and on the whole tile (one 5,242,932-value
                row), a ragged two-group image, 512x512 crops with 1-4
                channels, at q 0, 1, 4, 16, 64, 16384 and 65536, gate 0 and
                16, chroma_loss 0, 1 and 3; random full-range streams; and
                streams built for the span cut on this card's grid
                (k8_edge_cases: a flush on a span edge, a row of one
                value, spans with no mismatch, 1, 3, 80, 81 and 200 rows
                and more rows than CTAs, n not a multiple of 8, -32768)
     parallel_kernels
              - K7 (lift_level_shards / unlift_level_shards,
                csrc/lift_level.cu's shard-table instances) bit for bit
                against their plain versions: every wavelet x wrap, every
                sharded level of the whole tile over 8 and 3 shards, the
                tractor size (1632x2464) over 8, 127x127, 96x100 and T = 25
                pairs over 8; launches of every shard at once and of
                alternate shards, their sources cut into segments in
                buffers of their own (poisoned outside them, some rows not
                16-byte aligned), the outputs poisoned before and compared
                whole; and each shard alone on its window buffer
                (lift_level_rows / unlift_level_rows, poisoned outside it);
                an empty shard refused with no launch
  4. goldens  - tests/golden blobs and pixels are reproduced exactly,
                on both entropy paths
  5. north    - the north-star image (fbm corpus, seed 42, 1024x1280
                RGBA) through encode/decode at 128-px tiles, at the
                default whole-image tile and lossless q=0: on the host
                entropy path, then on the device-entropy path in both
                lift wirings (fused, split); and MANBAVARAN under
                AKO_TPU_MANBAVARAN=1 at 128-px tiles and the whole tile
                (north_t128_manba, default_whole_manba). Blobs byte-equal
                and pixels bit-equal to the native tile codec
                (runtime/hostcodec.py: the one-call Kagari codec, or the
                per-tile colour, lift and rANS coder); no host fallback
                tile; each path's kernel launches counted from zero and
                exact (one manba_encode and one manba_decode per shape
                group of a MANBAVARAN device-entropy setting)
  6. profile  - torch.profiler over one warm north-star encode and
                decode on each path: device time per kernel, device busy
                and idle share; K3 alone on the north star's streams and
                the whole tile's (one device kernel a call, and no other
                device work) beside its plain version's torch ops; and
                over the default whole tile's device-entropy encode and
                decode, where the fused wiring runs lift_level /
                unlift_level on levels 0-2, and over both MANBAVARAN
                settings' device-entropy encode and decode; on the split
                wiring no device work between a level's K1v (K2v)
                launches, and the launch floor (an empty kernel's device
                time)
  7. timings  - encode/decode ms and MP/s, per-stage host times,
                per-level kernel time against the plain torch version
                (lift_level / unlift_level and K1/K2 on the whole tile's
                levels before pyramid_start, the split wiring's K1v/K2v
                calls on the north star's, profiler and CUDA events), and the pyramid kernels' device ms per start
                level and per tile count; for MANBAVARAN on both paths;
                K6e and K6d alone against their plain versions and the
                native coder, and K6e's latency bound: the latencies of
                the chain step's operations (dependent chains on the
                card), the chain loop of manba_chain_pack in the
                library's SASS (cuobjdump: its dependent path and
                instructions a step) and the SM clock and ns a step of
                the chain alone on the north star's tile 0 stream; and
                K6d's latency bound on both settings: its chain loop's
                SASS (the dependent path through the table's shared load),
                the shared and L2 load latencies (the load chains of
                ako_manba_op_latency) and the SM clock of K6e's chain
                alone
  8. streams  - device ms and host enqueue ms of encode.forward_streams
                and decode.stream_pixels on the north star's 128-px tile
                group and on the default whole tile: kernel launches,
                device kernels, torch ops, copies and host waits for the
                device, from torch.profiler
  9. executor - runtime/executor.py on bench.py's stream (corpus(42, 12,
                1280, 1024, 4)) at north_t128: PipelineEncoder /
                PipelineDecoder (sequential) and roundtrip_iter, then
                default_whole_manba at 4 images and the host modes
                (AKO_TPU_ENCODE=host, AKO_TPU_DECODE=host); every blob and
                image equal to the native oracle, the launches N times one
                image's, no host fallback; over one warm sequential stream
                under torch.profiler the codec's kernels on more than one
                CUDA stream, no pageable copy, and the device busy share;
                the stream MP/s of both modes (4 and os.cpu_count()
                workers) against a one-shot encode / decode loop over the
                same images (medians of 5 turns after a warm-up), and
                single-image p50 / p95 latency
 10. rate     - tools/rate.encode_with_ratio on the north star at 128-px
                tiles (ratio 4 and 12, gate 0 and 16) and on the whole
                tile (ratio 12): every probe's size equal to the length of
                the native codec's blob at its q, the blob byte-equal to the
                native codec's and to the port's encode at the emitted q,
                the launches exact (the lift once per colour variant and
                shape group, one K8p per probe and shape group, one K8s and
                one K3 per shape group at the end); the probe trajectory,
                the search's wall ms against one-shot encodes at its q's,
                a search's device busy share, and K8p and K8s alone
 11. cli      - python -m ako_tpu_torch.tools.akoenc / akodec on the card,
                each in a process of its own, on the north star written
                by the port's pngout: -t 128 -q 16 byte-equal to the native
                codec, -dev-r 12 equal to phase 10's blob, the decoded PNG's
                pixels equal to the native decode's, a truncated blob exit
                1 with an akodec: message
 12. parallel - ako_tpu_torch.parallel, every shard on a stream of its own
                (a mesh of repeated cuda:0; of distinct cards too when the
                machine has several): forward/inverse_tile_sharded on the
                whole tile over 8 and 3 shards under all four wraps and the
                tractor size over 8, with K7's launches the plan's (one a
                sharded level and device) and no halo copy on one card, each
                stream equal to forward_tile's and the native codec's and
                each reconstruction to inverse_tile's and the native one;
                encode/decode_image_sharded at 128-px tiles over 8 and 3
                shards (both entropy routes) against the port's encode and
                the native oracle; a step on a 2 x 4 (tiles, rows) mesh;
                HostShardedPipeline in two processes sharing the card over
                gloo (this script with --multihost-worker); then K7 alone
                on one whole-tile call's launches (profiler, CUDA events,
                plain, per level, bound, and the launches back to back
                against their profiled sum), the sharded whole tile's wall and
                device busy against the one-device routes, the copies, and
                the tile-sharded encode / decode against the one-shot ones

The second-to-last stdout line is the card's name and power limit from
nvidia-smi, before it a JSON line with each kernel's launches, error,
times and bound; the last line is the JSON result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback

if __name__ == "__main__":
    # torch.profiler leaves CUPTI set up from one window to the next; so
    # kept, it records fewer of a window's device events the longer the
    # process has profiled (on the H100 machine most short windows recorded
    # none after about a minute; torn down after each window, every window
    # recorded them: chip_probe.py profiler). Set before torch is imported;
    # such a process hangs in its exit, so the script ends with os._exit.
    os.environ.setdefault("TEARDOWN_CUPTI", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
NORTH_STAR = dict(seed=42, h=1280, w=1024, ch=4)  # 1024x1280 (w x h) RGBA
RUNS = 7  # timed runs per measurement, after one warm-up
KERNEL_ITERS = 50  # back-to-back launches per CUDA-event timing
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
#: 32-bit integer lanes of an H100 SXM: 132 SMs of 64 INT32 lanes each
#: (the data sheet's 67 TFLOP/s float32 counts 128 FP32 lanes a SM and an
#: FMA as two operations); int_ops_per_s gives the rate at the SM clock
INT32_LANES = 132 * 64
#: integer operations per sample of one 1-D DD 13/7 lift (predict: 4
#: taps, a multiply, the rounding shift and the add; update the same),
#: the costliest wavelet, so an upper count on CDF 5/3 levels
LIFT_OPS = 9
#: integer operations per value K4 decodes: the window shift and
#: refill, __clz, the gamma length and value, the unzigzag, the run
#: compare and counters
K4_OPS = 20
#: integer operations per value K3 codes: the zigzag, the compare with
#: the neighbours, the max and sum scans, the run counter's modulo and
#: tests, two gamma lengths, and placing a code's parts in its words
K3_OPS = 30
#: integer operations per value K6e codes: the zigzag, the symbol's
#: __clz and histogram vote, the chain step (two compares, the
#: multiply-high, three shifts and three multiply-adds), the emitted
#: bytes' compares and placement, and the extras' scan and placement
K6E_OPS = 25
#: integer operations per value K6d decodes: the slot table's fields,
#: the state update, the refill compares and merges, the extras window
#: and the unzigzag
K6D_OPS = 20
#: (path name, device_entropy, lift wiring)
PATHS = [("host", False, "fused"), ("device_fused", True, "fused"), ("device_split", True, "split")]
REPLACES = {
    "lift2d": "ako_tpu/ops/pallas_lift.py:90",
    "unlift2d": "ako_tpu/ops/pallas_lift.py:184",
    "vlift": "ako_tpu/ops/pallas_lift.py:127",
    "vunlift": "ako_tpu/ops/pallas_lift.py:211",
    "kagari_decode": "ako_tpu/ops/kagari_device.py:569",
    "kagari_encode": "ako_tpu/ops/kagari_device.py:665",
    "lift_pyramid": "ako_tpu/ops/pallas_lift.py:90",
    "unlift_pyramid": "ako_tpu/ops/pallas_lift.py:184",
    "lift_level": "ako_tpu/ops/pallas_lift.py:90",
    "unlift_level": "ako_tpu/ops/pallas_lift.py:184",
    "manba_encode": "ako_tpu/ops/manba_device.py:250",
    "manba_decode": "ako_tpu/ops/manba_device.py:96",
}
SOURCES = {k: "ako_tpu_torch/csrc/lift2d.cu" for k in REPLACES}
SOURCES["vlift"] = SOURCES["vunlift"] = "ako_tpu_torch/csrc/vlift.cu"
SOURCES["kagari_decode"] = "ako_tpu_torch/csrc/kagari_decode.cu"
SOURCES["kagari_encode"] = "ako_tpu_torch/csrc/kagari_encode.cu"
SOURCES["lift_pyramid"] = SOURCES["unlift_pyramid"] = "ako_tpu_torch/csrc/lift_pyramid.cu"
SOURCES["lift_level"] = SOURCES["unlift_level"] = "ako_tpu_torch/csrc/lift_level.cu"
SOURCES["manba_encode"] = "ako_tpu_torch/csrc/manba_encode.cu"
SOURCES["manba_decode"] = "ako_tpu_torch/csrc/manba_decode.cu"
#: the (path, setting) whose profiled run gives each kernel's JSON row:
#: the fused device-entropy north star at 128-px tiles, but K1v/K2v run
#: only in the split wiring, and lift_level / unlift_level only on the
#: levels of the default whole tile before pyramid_start. K1/K2 run on no
#: path of the codec: their rows are timed by kernel_times alone on the
#: whole tile's levels 0-2, and their launches are 0.
ROW_RUN = {k: ("device_fused", "north_t128") for k in REPLACES}
ROW_RUN.update(vlift=("device_split", "north_t128"), vunlift=("device_split", "north_t128"),
               **{k: ("device_fused", "default_whole")
                  for k in ("lift2d", "unlift2d", "lift_level", "unlift_level")},
               manba_encode=("device_fused", "north_t128_manba"),
               manba_decode=("device_fused", "north_t128_manba"))
#: profiler kernel names -> kernel of the JSON line
DEVICE_KERNELS = {
    "lift_h": "lift2d", "lift_v": "lift2d", "unlift_v": "unlift2d", "unlift_h": "unlift2d",
    "vlift": "vlift", "vunlift": "vunlift", "kagari_decode": "kagari_decode",
    "kagari_encode": "kagari_encode",
    "lift_pyramid": "lift_pyramid", "unlift_pyramid": "unlift_pyramid",
    "lift_level": "lift_level", "unlift_level": "unlift_level",
    "manba_stats": "manba_encode", "manba_model": "manba_encode",
    "manba_chain_pack": "manba_encode", "manba_decode": "manba_decode",
    "rate_serialize": "rate_serialize", "rate_sizes": "rate_sizes",
    "lift_level_shards": "lift_level_shards", "unlift_level_shards": "unlift_level_shards",
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


_INT_OPS = []


def int_ops_per_s() -> float:
    """The card's peak of the kernels' 32-bit integer adds, shifts and
    compares: INT32_LANES a clock at the SM clock's maximum that nvidia-smi
    reads (clocks.max.sm), asked once."""
    if not _INT_OPS:
        res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        mhz = float(res.stdout.strip().splitlines()[0].split()[0])
        _INT_OPS.append(INT32_LANES * mhz * 1e6)
    return _INT_OPS[0]


def north_star_settings(P):
    return {
        "north_t128": P.Settings(quantization=16, tiles_dimension=128),
        "default_whole": P.Settings(),
        "lossless_t128": P.Settings(quantization=0, gate=0, tiles_dimension=128),
    }


def manba_settings(P):
    """The MANBAVARAN settings of the north-star phase, each run with
    AKO_TPU_MANBAVARAN=1 (manba_env)."""
    m = P.Compression.MANBAVARAN
    return {
        "north_t128_manba": P.Settings(quantization=16, tiles_dimension=128, compression=m),
        "default_whole_manba": P.Settings(compression=m),
    }


@contextlib.contextmanager
def manba_env(on: bool = True):
    """AKO_TPU_MANBAVARAN=1 inside the block when `on` (the MANBAVARAN
    settings code rANS under it), and the variable as it was after."""
    old = os.environ.get("AKO_TPU_MANBAVARAN")
    if on:
        os.environ["AKO_TPU_MANBAVARAN"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("AKO_TPU_MANBAVARAN", None)
        else:
            os.environ["AKO_TPU_MANBAVARAN"] = old


def is_manba(name: str) -> bool:
    return name.endswith("_manba")


def all_launches() -> dict:
    from ako_tpu_torch.ops import kagari_device, lift_kernels, manba_device, rate_device

    return {**lift_kernels.LAUNCHES, **kagari_device.LAUNCHES, **manba_device.LAUNCHES,
            **rate_device.LAUNCHES}


def reset_launches() -> None:
    from ako_tpu_torch.ops import kagari_device, lift_kernels, manba_device, rate_device

    for counts in (lift_kernels.LAUNCHES, kagari_device.LAUNCHES, manba_device.LAUNCHES,
                   rate_device.LAUNCHES):
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
    stack = max((int(b) for b in re.findall(r"(\d+) bytes stack frame", kernels.build_log)),
                default=0)
    log(f"build: nvcc lift2d.cu, vlift.cu, lift_pyramid.cu, lift_level.cu, kagari_encode.cu, "
        f"kagari_decode.cu, manba_encode.cu, manba_decode.cu, rate.cu "
        f"{t_cuda:.2f} s, cc csrc/akort.c "
        f"{t_akort:.2f} s; ptxas max registers {max(regs, default=0)}, spill stores {spills} B, "
        f"largest stack frame {stack} B")
    lines = kernels.build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and any(
                k in line for k in ("pyramid", "kagari", "lift_level", "unlift_level", "manba",
                                    "vlift", "vunlift", "rate_")):
            log("  ptxas: " + " | ".join(part.strip() for part in lines[i : i + 4]))


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
    """(n, h, w, axis, level target or None) of the V-only calls: the split
    wiring's on each 128-px level (its plane along -1, then the
    half-width planes along -2), then odd heights and widths, 1-px and
    2-px sides, 4x4 planes and one whole 1024x1280 (w x h) plane, along
    both axes."""
    from ako_tpu_torch.core import geometry

    h, w, ch = img.shape
    n = (h // tiles_dimension) * (w // tiles_dimension) * ch
    shapes = []
    for lvl in geometry.lift_schedule(tiles_dimension, tiles_dimension).levels:
        shapes.append((n, lvl.current_h, lvl.current_w, -1, lvl))
        shapes.append((n, lvl.current_h, lvl.target_w, -2, lvl))
    extra = [(3, 127, 97), (3, 5, 9), (3, 64, 97), (4, 1, 40), (4, 40, 1), (2, 1, 1), (3, 2, 301),
             (5, 4, 4), (1, 1280, 1024)]
    return shapes + [(*shape, axis, None) for shape in extra for axis in (-1, -2)]


def phase_vlift_kernels(dev, shapes) -> dict:
    """K1v/K2v against vlift/vunlift on the card, every wavelet x wrap
    (the level's effective wavelet on level shapes; CDF 5/3 for DD 13/7 on
    lines of fewer than 3 pairs, as no level lifts them), one call a
    launch and two."""
    from ako_tpu_torch.core.settings import Wavelet, Wrap
    from ako_tpu_torch.ops import lift_kernels, wavelets

    rng = np.random.default_rng(1)
    err = {"vlift": 0, "vunlift": 0}
    for (n, h, w, axis, lvl), wavelet, wrap in itertools.product(
        shapes, [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR], list(Wrap)
    ):
        length = w if axis == -1 else h
        if lvl is not None:
            weff = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        else:
            weff = Wavelet.CDF53 if wavelet == Wavelet.DD137 and length < 5 else wavelet
        xs = [_rand16(rng, (n, h, w), dev) for _ in range(2)]
        got = [lift_kernels.vlift_level(weff, wrap, xs[0], axis),
               *lift_kernels.vlift_pair(weff, wrap, *xs, axis)]
        ref = [wavelets.vlift(weff, wrap, x, axis) for x in (xs[0], *xs)]
        e_fwd = max(_max_err(g, r) for gs, rs in zip(got, ref) for g, r in zip(gs, rs))
        shape = ref[0][0].shape
        pairs = [tuple(_rand16(rng, shape, dev) for _ in range(2)) for _ in range(2)]
        got = [lift_kernels.vunlift_level(weff, wrap, *pairs[0], length, axis),
               *lift_kernels.vunlift_pair(weff, wrap, *pairs, length, axis)]
        ref = [wavelets.vunlift(weff, wrap, *p, length, axis) for p in (pairs[0], *pairs)]
        e_inv = max(_max_err(g, r) for g, r in zip(got, ref))
        err["vlift"] = max(err["vlift"], e_fwd)
        err["vunlift"] = max(err["vunlift"], e_inv)
        if e_fwd or e_inv:
            raise AssertionError(f"K1v/K2v != plain for {weff.name} {wrap.name} {(n, h, w)} "
                                 f"axis {axis}: vlift {e_fwd}, vunlift {e_inv}")
    torch.cuda.synchronize()
    log(f"kernels: K1v/K2v equal to plain on {len(shapes)} calls x 3 wavelets x 4 wraps, one and "
        "two calls a launch")
    return err


#: (tiles, w, h, channels) of the pyramid kernels' checks: the north
#: star's 128-px tile group, odd and small tiles, tiles with no level,
#: and tiles with fewer rows than channels (an image's edge row of
#: tiles: some of the inverse's cluster blocks store no row)
PYRAMID_SHAPES = [(80, 128, 128, 4), (3, 127, 97, 3), (3, 33, 17, 4), (2, 5, 9, 2), (2, 2, 2, 1),
                  (2, 2, 2, 4), (3, 128, 3, 4), (2, 128, 1, 3)]


def _pyramid_cases():
    """(tiles, schedule, channels, start, wavelet, wrap, colour, discard,
    q) of phase_pyramid_kernels: every wavelet x wrap on each shape with
    the colour, discard and q cycling, every start level on the small
    shapes, and the default whole 1024x1280 tile from its start level."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.core.settings import Color, Wavelet, Wrap
    from ako_tpu_torch.ops.lift_kernels import pyramid_start

    colours = [Color.YCOCG_Q, Color.YCOCG, Color.SUBTRACT_G, Color.NONE]
    pairs = list(itertools.product([Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR], list(Wrap)))
    cases = []
    for n, w, h, ch in PYRAMID_SHAPES:
        schedule = geometry.lift_schedule(w, h)
        starts = [0] if n > 3 else range(len(schedule.levels) + 1)
        for i, (wavelet, wrap) in enumerate(pairs):
            cases += [(n, schedule, ch, start, wavelet, wrap, colours[i % 4], i % 2 == 1,
                       (0, 1, 16)[i % 3]) for start in starts]
    whole = geometry.lift_schedule(1024, 1280)
    cases.append((1, whole, 4, pyramid_start(whole, 4), Wavelet.DD137, Wrap.CLAMP, Color.YCOCG_Q,
                  False, 16))
    return cases


def _random_streams(rng, dev, n, schedule, ch):
    """Random int16 streams whose q heads are 0, 1 or above 1 (7, 300:
    the dequantize multiply wraps) or negative."""
    from ako_tpu_torch.ops.lift_kernels import level_offsets

    stream = rng.integers(-32768, 32768, size=(n, schedule.coeff_count(ch))).astype(np.int16)
    for off, lvl in zip(level_offsets(schedule, ch), schedule.levels):
        m = 1 + 3 * lvl.target_h * lvl.target_w
        stream[:, off : off + ch * m : m] = rng.choice([0, 1, 7, 300, -5], size=(n, ch))
    return torch.from_numpy(stream).to(dev)


def phase_pyramid_kernels(dev) -> dict:
    """lift_pyramid / unlift_pyramid against their plain versions on the
    same inputs on the card (_pyramid_cases); returns the largest
    absolute difference per kernel (must be 0)."""
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.ops.quantization import level_qg

    rng = np.random.default_rng(3)
    err = {"lift_pyramid": 0, "unlift_pyramid": 0}
    cases = _pyramid_cases()
    for n, schedule, ch, start, wavelet, wrap, color, discard, q in cases:
        qg = level_qg(schedule, ch, q, 3, 2)
        if start == 0:
            tiles = rng.integers(0, 256, size=(n, schedule.tile_h, schedule.tile_w, ch))
            if discard:
                tiles[..., -1][rng.random(tiles.shape[:-1]) < 0.3] = 0
            x = torch.from_numpy(tiles.astype(np.uint8)).to(dev)
        else:
            x = _rand16(rng, (n, ch, *lk._start_shape(schedule, start)), dev)
        got = torch.zeros((n, schedule.coeff_count(ch)), dtype=torch.int16, device=dev)
        ref = torch.zeros_like(got)
        lk.forward_pyramid(x, got, schedule, start, wavelet, wrap, qg, color, discard)
        lk.forward_pyramid_plain(x, ref, schedule, start, wavelet, wrap, qg, color, discard)
        stream = _random_streams(rng, dev, n, schedule, ch)
        e_fwd = _max_err(got, ref)
        e_inv = _max_err(lk.inverse_pyramid(stream, schedule, start, wavelet, wrap, ch, color),
                         lk.inverse_pyramid_plain(stream, schedule, start, wavelet, wrap, ch, color))
        err["lift_pyramid"] = max(err["lift_pyramid"], e_fwd)
        err["unlift_pyramid"] = max(err["unlift_pyramid"], e_inv)
        if e_fwd or e_inv:
            raise AssertionError(
                f"pyramid kernels != plain for {n} tiles {schedule.tile_w}x{schedule.tile_h}x{ch} "
                f"from level {start}, {wavelet.name} {wrap.name} {color.name} discard {discard} "
                f"q {q}: lift_pyramid {e_fwd}, unlift_pyramid {e_inv}")
    torch.cuda.synchronize()
    log(f"kernels: lift_pyramid/unlift_pyramid equal to plain on {len(cases)} cases "
        f"({len(PYRAMID_SHAPES)} tile shapes x 3 wavelets x 4 wraps x their start levels, "
        "4 colours, 1-4 channels, and the 1024x1280 tile from its start level)")
    return err


#: (tiles, w, h, channels, levels or None for every level) of
#: phase_level_kernels: the whole tile's levels 0-2, 256-px tiles' level
#: 0, odd sides, a thin tile (its one level and the LP head), 9 channels
#: (every level: no pyramid), and small planes whose level_region is
#: small too, where a last region is narrower than its halo and REPEAT's
#: window is wider than the line (64x48: rows of 16-byte multiples at
#: every level, for the cp.async loads)
LEVEL_SHAPES = [(1, 1024, 1280, 4, range(3)), (20, 256, 256, 3, range(1)),
                (3, 301, 257, 3, range(2)), (1, 100000, 3, 4, None), (2, 40, 24, 9, None),
                (2, 53, 37, 1, None), (2, 33, 17, 2, None), (2, 301, 257, 4, range(2)),
                (2, 64, 48, 3, None)]


def phase_level_kernels(dev) -> dict:
    """lift_level / unlift_level against their plain versions
    (forward_levels_plain / inverse_levels_plain) on the same inputs on
    the card, every wavelet x wrap on each of LEVEL_SHAPES with the
    colour, discard and q cycling; the inverse on random streams whose q
    heads wrap, from the LL the pyramid would hand it (or the LP head).
    Returns the largest absolute difference per kernel (must be 0)."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.core.settings import Color, Wavelet, Wrap
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.ops.quantization import level_qg

    rng = np.random.default_rng(7)
    colours = [Color.YCOCG_Q, Color.YCOCG, Color.SUBTRACT_G, Color.NONE]
    pairs = list(itertools.product([Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR], list(Wrap)))
    err = {"lift_level": 0, "unlift_level": 0}
    cases = 0
    for n, w, h, ch, levels in LEVEL_SHAPES:
        schedule = geometry.lift_schedule(w, h)
        levels = levels or range(len(schedule.levels))
        for i, (wavelet, wrap) in enumerate(pairs):
            color, discard, q = colours[i % 4], i % 2 == 1, (0, 1, 16)[i % 3]
            qg = level_qg(schedule, ch, q, 3, 2)
            tiles = rng.integers(0, 256, size=(n, h, w, ch))
            if discard:
                tiles[..., -1][rng.random(tiles.shape[:-1]) < 0.3] = 0
            x = torch.from_numpy(tiles.astype(np.uint8)).to(dev)
            got = torch.zeros((n, schedule.coeff_count(ch)), dtype=torch.int16, device=dev)
            ref = torch.zeros_like(got)
            fwd = (wavelet, wrap, qg, color, discard)
            ll = lk.forward_levels(x, got, schedule, levels, *fwd)
            ll_ref = lk.forward_levels_plain(x, ref, schedule, levels, *fwd)
            e_fwd = max(_max_err(got, ref), _max_err(ll, ll_ref))
            stream = _random_streams(rng, dev, n, schedule, ch)
            if levels.stop == len(schedule.levels):
                top = lk.lp_view(stream, schedule, ch)
            else:
                lvl = schedule.levels[levels.stop]
                top = _rand16(rng, (n, ch, lvl.current_h, lvl.current_w), dev)
            inv = (wavelet, wrap, ch, color)
            e_inv = _max_err(lk.inverse_levels(top, stream, schedule, levels, *inv),
                             lk.inverse_levels_plain(top, stream, schedule, levels, *inv))
            err["lift_level"] = max(err["lift_level"], e_fwd)
            err["unlift_level"] = max(err["unlift_level"], e_inv)
            cases += 1
            if e_fwd or e_inv:
                raise AssertionError(
                    f"level kernels != plain for {n} tiles {w}x{h}x{ch} levels {levels}, "
                    f"{wavelet.name} {wrap.name} {color.name} discard {discard} q {q}: "
                    f"lift_level {e_fwd}, unlift_level {e_inv}")
    torch.cuda.synchronize()
    log(f"kernels: lift_level/unlift_level equal to plain on {cases} cases "
        f"({len(LEVEL_SHAPES)} shapes x 3 wavelets x 4 wraps, 4 colours, 1-4 and 9 channels)")
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
    int16 extremes, runs across blocks), and high-entropy streams whose
    CTA spans are too wide for shared memory (the route that reads the
    pool; kagari_device.decode_cta_spans says which CTAs take it)."""
    from ako_tpu_torch.ops import kagari_device as kd

    rng = np.random.default_rng(2)
    runs = rng.integers(-300, 300, size=20000)
    runs[rng.random(20000) < 0.6] = 0
    edges = [np.zeros(70000), np.full(1 + 2 * 65534 + 10, -2), np.array([32767] * 600 + [-32767] * 600),
             np.array([-32767, 32767, 0, -1, 1] * 300), runs, np.array([3, 3, 3]), np.array([7]),
             rng.integers(-32767, 32768, size=20000), rng.integers(-32767, 32768, size=70001)]
    cases = [(parts, n, span, None) for parts, n, span in entropy_inputs(north_blob, dev)]
    cases += [_edge_blob_inputs(v, dev) for v in edges]
    err = 0
    routes = {"staged": 0, "pool": 0}
    for parts, n, span, want in cases:
        spans = kd.decode_cta_spans(parts[1].cpu().numpy(), parts[2].cpu().numpy(),
                                    parts[0].shape[0])
        routes["staged"] += int(spans["staged"].sum())
        routes["pool"] += int((~spans["staged"]).sum())
        got = kd.kagari_decode_device(*parts, n)
        ref = kd._decode_plain(*parts, n, kd.DECODE_BLOCK, span)
        e = _max_err(got, ref)
        err = max(err, e)
        if e or (want is not None and not np.array_equal(got.cpu().numpy()[0], want)):
            raise AssertionError(f"K4 != plain (or the stream) on a {tuple(got.shape)} case: {e}")
    if not routes["staged"] or not routes["pool"]:
        raise AssertionError(f"K4: a route went unchecked: CTAs {routes}")
    torch.cuda.synchronize()
    log(f"kernels: K4 equal to plain on the north star's streams and {len(edges)} edge streams; "
        f"CTAs by route {routes}")
    return err


def group_streams(dev, img, s) -> list:
    """(streams, capacity, budget) per shape group of one setting: the
    coefficient streams on the card as the device-entropy encoder makes
    them, with its Kagari capacity and pack budget."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import (checked_settings, forward_streams, pack_budget, stage_tiles,
                                      tile_stream_bytes)
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD

    s = checked_settings(s)
    h, w, ch = img.shape
    src = torch.from_numpy(np.ascontiguousarray(img))
    out = []
    for (tw, th), tiles in geometry.group_by_shape(geometry.tile_grid(w, h, s.tiles_dimension)).items():
        streams = forward_streams(stage_tiles(src, tiles, tw, th).to(dev), tw, th, ch, s)
        cap = tile_stream_bytes(tiles[0], s, ch) - BLOCK_HEAD.size
        out.append((streams, cap, pack_budget(cap, s.quantization)))
    return out


def k3_cases(P, dev, img) -> list:
    """(name, streams, capacity, budget) of phase_k3: the encoder's
    streams and budgets of every north-star setting (80 streams of 65560
    values at 128-px tiles, lossy and lossless; the whole-image tile's
    one stream of 5,242,932), budgets that cut them (inside a word and
    on a word boundary), and edge streams: runs, a forced flush and
    -32768 across the kernel's chunks, the densest codes (32 bits a
    position), full-range noise."""
    from ako_tpu_torch.ops.kagari_device import K3_CHUNK

    cases = []
    for name, s in north_star_settings(P).items():
        for i, (streams, cap, budget) in enumerate(group_streams(dev, img, s)):
            cases.append((f"{name}[{i}]", streams, cap, budget))
            cases.append((f"{name}[{i}] cut", streams, cap, 1001 if streams.shape[0] > 1 else 100004))
    rng = np.random.default_rng(6)
    c = K3_CHUNK
    wrap = rng.integers(-40, 40, size=3 * c + 100)
    wrap[[0, c, 2 * c, 3 * c]] = -32768
    wrap[c - 2 : c + 3] = -32768
    edges = {
        "runs across chunks": [1] * (c - 5) + [2] * 10 + [3] * (2 * c) + [4] * c + list(range(300)),
        "flush in a later chunk": [7] * (1 + 2 * 65534 + 10),
        "-32768 at chunk starts": wrap,
        "densest codes": [32767] * 3 + [-32767] * 3,
        "full-range noise": rng.integers(-32768, 32768, size=300001),
        "all equal": np.full(40 * c + 17, -9),
        # 70 chunks with no mismatch (more than two look-back windows),
        # a forced flush inside
        "run over many chunks with a flush": np.concatenate(
            [rng.integers(-9, 9, size=c + 100), np.full(70 * c, 4), rng.integers(-9, 9, size=c)]),
    }
    for name, v in edges.items():
        v = np.asarray(v, np.int16)
        if name == "densest codes":
            v = np.tile(v, 20000)
        t = torch.from_numpy(np.stack([v, v[::-1].copy()])).to(dev)
        cases.append((name, t, 4 * v.size, 4 * v.size))
    return cases


def k3_plain(streams, budget):
    """K3's plain version on the card: (bytes, totals) from tokenize +
    pack_bits, the torch ops a CPU tensor takes."""
    from ako_tpu_torch.ops import kagari_device as kd

    vals, nbits = kd.tokenize(streams)
    by, total_bits = kd.pack_bits(vals, nbits, budget)
    return by, (total_bits + 7) >> 3


def phase_k3(P, dev, img) -> int:
    """K3 against its plain version (tokenize + pack_bits, torch ops on
    the card) on k3_cases: bytes and totals bit for bit. Returns the
    largest absolute difference (must be 0)."""
    from ako_tpu_torch.ops import kagari_device as kd

    err, values = 0, 0
    cases = k3_cases(P, dev, img)
    for name, streams, cap, budget in cases:
        got, got_total = kd.kagari_encode_device(streams, cap, budget)
        ref, ref_total = k3_plain(streams, budget)
        e = max(_max_err(got, ref), int((got_total - ref_total).abs().max()))
        err = max(err, e)
        values += streams.numel()
        if e or not torch.equal(got, ref) or not torch.equal(got_total, ref_total):
            raise AssertionError(f"K3 != plain on {name} {tuple(streams.shape)} budget {budget}: {e}")
        cut = int((ref_total > budget).sum())
        log(f"  K3 {name} {tuple(streams.shape)} budget {budget}: equal ({cut} rows past the budget)")

    # the scratch is reused: calls of other shapes back to back, each
    # call's epoch making the descriptors of the others stale
    plains = {}
    order = [cases[0], cases[-1], cases[2], cases[-3], cases[0], cases[2]]
    outs = [kd.kagari_encode_device(t, cap, budget) for _, t, cap, budget in order]
    for (name, streams, cap, budget), (got, got_total) in zip(order, outs):
        ref, ref_total = plains.get(name) or plains.setdefault(name, k3_plain(streams, budget))
        if not (torch.equal(got, ref) and torch.equal(got_total, ref_total)):
            raise AssertionError(f"K3 != plain on {name} called back to back with other shapes")
    log(f"  K3 back to back on {[tuple(t.shape) for _, t, _, _ in order]}: each equal")
    # 100 calls on the north star's streams, each byte-equal to the first
    name, streams, cap, budget = cases[0]
    first = kd.kagari_encode_device(streams, cap, budget)
    outs = [kd.kagari_encode_device(streams, cap, budget) for _ in range(100)]
    for got, got_total in outs:
        if not (torch.equal(got, first[0]) and torch.equal(got_total, first[1])):
            raise AssertionError(f"K3 on {name}: a repeated call differs from the first")
    log(f"  K3 100 repeated calls on {name} {tuple(streams.shape)}: each equal to the first")
    torch.cuda.synchronize()
    log(f"kernels: K3 equal to plain on {values} values")
    return err


def manba_kinds() -> dict:
    """The kinds of tests/test_manbavaran.py's device-encoder parity test
    (one int16 stream each), and a lossy-like stream that crosses many
    of K6e's chunks."""
    rng = np.random.default_rng(0x2A15)
    return {
        "photo": (rng.normal(0, 2.2, size=21846) ** 3 / 8).astype(np.int16),
        "zeros": np.zeros(5000, np.int16),
        "fullrange": rng.integers(-32768, 32768, size=3000).astype(np.int16),
        "int16min": np.tile(np.array([-32768, 7, -32768, 0], np.int16), 500),
        "single": np.array([123], np.int16),
        "runs": np.repeat(rng.integers(-60, 60, size=40).astype(np.int16), 173),
        "chunks": (rng.normal(0, 3.0, size=20 * 4096 + 333) ** 3 / 9).astype(np.int16),
        **k6_step_kinds(rng),
    }


def k6_step_kinds(rng) -> dict:
    """Streams that take K6e's step through its cases: symbols of f = 1
    (the divider's k = 0 never taken), a dominant symbol near f = 4096
    (no renorm most steps), and half of the values full-range, so that
    symbols of f below 16 renorm twice beside symbols of f >= 32."""
    return {
        "f1": np.concatenate([np.zeros(9000, np.int16), np.array([-32768, 20000, 3, 900], np.int16),
                              rng.integers(-3, 4, 9000).astype(np.int16)]),
        "dominant": np.where(rng.random(24000) < 0.0008, 1, 0).astype(np.int16),
        "renorm2": np.where(rng.random(20000) < 0.5, rng.integers(-32768, 32768, 20000),
                            rng.integers(-2, 3, 20000)).astype(np.int16),
    }


def k6e_used(record, rans, extras, budget) -> tuple:
    """K6e's outputs cut to what they define: the record, the rANS row's
    last min(rans bytes, budget) bytes and the extras row's first
    min(extras bytes, budget), on the host."""
    from ako_tpu_torch.ops.manba_device import unpack_record

    rec = record.cpu().numpy()
    _, _, rb, eb, _ = unpack_record(rec)
    rans, extras = rans.cpu().numpy(), extras.cpu().numpy()
    rows = [(rans[i, budget - min(int(rb[i]), budget):].tobytes(),
             extras[i, : min((int(eb[i]) + 7) // 8, budget)].tobytes()) for i in range(len(rec))]
    return rec, rows


def manba_payloads(record, rans, extras, capacity) -> list:
    """The payload manba_assemble frames from each row of K6e's outputs
    (None where it does not fit), as encode.encode_tiles_blocks_manba."""
    from ako_tpu_torch.ops.manba_device import unpack_record
    from ako_tpu_torch.runtime.kagari import manba_assemble

    freq, x, rb, eb, ok = unpack_record(record.cpu())
    rans, extras = rans.cpu().numpy(), extras.cpu().numpy()
    budget = rans.shape[1]
    return [manba_assemble(freq[i], x[i], rans[i, budget - min(int(rb[i]), budget):], rb[i],
                           extras[i], eb[i], ok[i], capacity) for i in range(len(freq))]


def manba_decode_inputs(payloads, n, dev):
    """K6d's upload for payloads of n values each (as decode.py builds
    it), on the card, with the plain version's spans."""
    from ako_tpu_torch.decode import manba_spans, pack_manba_upload, split_manba_upload
    from ako_tpu_torch.ops.manba_device import DECODE_BLOCK
    from ako_tpu_torch.runtime.kagari import manba_sync

    items = []
    for p in payloads:
        sync = manba_sync(n, p, DECODE_BLOCK)
        if sync is None or sync[7] != len(p):
            raise AssertionError("K6d inputs: a payload akort_manba_sync rejects")
        items.append((None, p, sync))
    buf, T, B = pack_manba_upload(items)
    return split_manba_upload(torch.from_numpy(buf).to(dev), T, B), manba_spans(items)


def k6_cases(P, dev, img) -> list:
    """(name, streams on the card, budget) of phase_k6: the north star's
    80 streams at q=16 and lossless, a budget that cuts them, the kinds
    (one stream each, and three in one call)."""
    cases = []
    for name in ("north_t128", "lossless_t128"):
        ((streams, cap, _),) = group_streams(dev, img, north_star_settings(P)[name])
        cases.append((name, streams, cap))
    cases.append(("north_t128 cut", cases[0][1], 1001))
    for name, v in manba_kinds().items():
        cases.append((name, torch.from_numpy(v[None]).to(dev), v.size * 2 + 64))
    k = manba_kinds()
    n = 3000
    rows = np.stack([k["photo"][:n], k["fullrange"], k["int16min"][:n].repeat(2)[:n]])
    cases.append(("three kinds in one call", torch.from_numpy(rows).to(dev), 2 * n + 64))
    return cases


def k6d_edge_cases(dev) -> list:
    """(name, K6d inputs on the card, n, the streams or None) of
    tests/test_torch_manba_tiles.py's edge cases: zero frequencies at
    both ends of the model, 100, 128 and 1000 values (a tile of one block,
    n not a multiple of 128), 4101 values (a tile whose second CTA holds
    one lane of 5), three tiles of 1001 values (rows not 16-byte aligned),
    a pool that ends on the last payload's last word, and records no sync
    scan gives: no rANS byte left (rans_end 0), rANS bytes that run out
    inside a lane, extras cursors past the pool's end."""
    from ako_tpu_torch.ops.kagari_device import DECODE_SLACK_WORDS
    from ako_tpu_torch.runtime.kagari import manba_encode

    rng = np.random.default_rng(0x2A15)
    photo = (rng.normal(0, 2.2, size=21846) ** 3 / 8).astype(np.int16)
    rows = {
        "zero_ends": [rng.integers(1, 200, size=6000).astype(np.int16)],
        "100 values": [photo[:100]],
        "128 values": [photo[:128]],
        "1000 values": [photo[:1000]],
        "4101 values": [photo[: 32 * 128 + 5]],
        "3 x 1001 values": [photo[i * 1001 : (i + 1) * 1001] for i in range(3)],
    }
    cases = []
    for name, rs in rows.items():
        n = rs[0].size
        parts, _ = manba_decode_inputs([manba_encode(v, 2 * n + 64) for v in rs], n, dev)
        cases.append((name, parts, n, np.stack(rs)))
    n = photo.size
    parts, _ = manba_decode_inputs([manba_encode(photo, 2 * n + 64)], n, dev)
    pool, base, rans_end, extras_off, x, rbyte, ebit, freq = parts
    cases += [
        ("pool ending on the payload", (pool[:-DECODE_SLACK_WORDS], *parts[1:]), n, photo[None]),
        ("rans_end 0", (pool, base, torch.zeros_like(rans_end), *parts[3:]), n, None),
        ("rANS bytes out in lane 40", (pool, base, rbyte[:, 40:41].reshape(-1) + 3, *parts[3:]),
         n, None),
        ("extras past the pool", (*parts[:6], ebit + (pool.shape[0] * 32 - 900), freq), n, None),
    ]
    return cases


def phase_k6(P, dev, img) -> dict:
    """K6e and K6d against their plain versions on the card (k6_cases)
    and against the native coder; K6e's calls of other shapes back to
    back; the whole tile's stream against the native coder only. Returns
    the largest absolute difference per kernel (must be 0)."""
    from ako_tpu_torch.ops import manba_device as md
    from ako_tpu_torch.runtime.kagari import manba_decode, manba_encode

    err = {"manba_encode": 0, "manba_decode": 0}
    cases = k6_cases(P, dev, img)
    for name, streams, budget in cases:
        got = md.manba_encode_device(streams, budget)
        ref = md.manba_encode_plain(streams, budget)
        g_rec, g_rows = k6e_used(*got, budget)
        r_rec, r_rows = k6e_used(*ref, budget)
        err["manba_encode"] = max(err["manba_encode"], int(np.abs(g_rec - r_rec).max()))
        if not np.array_equal(g_rec, r_rec) or g_rows != r_rows:
            bad = np.flatnonzero((g_rec != r_rec).any(axis=1))
            raise AssertionError(f"K6e != plain on {name} {tuple(streams.shape)}: records of rows "
                                 f"{bad[:5]} or the bytes differ")
        values = streams.cpu().numpy()
        payloads = manba_payloads(*got, budget)
        cut = sum(p is None for p in payloads)
        for v, p in zip(values, payloads):
            if p is not None and p != manba_encode(v, budget):
                raise AssertionError(f"K6e on {name}: a payload differs from akort_manba_encode")
        log(f"  K6e {name} {tuple(streams.shape)} budget {budget}: equal to plain and to the "
            f"native coder ({cut} rows past the budget)")
        if cut:
            continue
        parts, spans = manba_decode_inputs(payloads, values.shape[1], dev)
        got = md.manba_decode_device(*parts, values.shape[1])
        ref = md.manba_decode_plain(*parts, values.shape[1], md.DECODE_BLOCK, *spans)
        e = _max_err(got, ref)
        err["manba_decode"] = max(err["manba_decode"], e)
        if e or not np.array_equal(got.cpu().numpy(), values):
            raise AssertionError(f"K6d != plain (or the stream) on {name}: {e}")
        log(f"  K6d {name}: equal to plain and to the stream")

    # calls of other shapes back to back
    order = [cases[0], cases[-1], cases[3], cases[0], cases[2]]
    outs = [md.manba_encode_device(t, b) for _, t, b in order]
    for (name, streams, budget), got in zip(order, outs):
        g_rec, g_rows = k6e_used(*got, budget)
        r_rec, r_rows = k6e_used(*md.manba_encode_plain(streams, budget), budget)
        if not np.array_equal(g_rec, r_rec) or g_rows != r_rows:
            raise AssertionError(f"K6e != plain on {name} called back to back with other shapes")
    log(f"  K6e back to back on {[tuple(t.shape) for _, t, _ in order]}: each equal")

    # the whole tile's one stream: the native coder only
    ((whole, cap, _),) = group_streams(dev, img, north_star_settings(P)["default_whole"])
    v = whole.cpu().numpy()[0]
    (payload,) = manba_payloads(*md.manba_encode_device(whole, cap), cap)
    if payload is None or payload != manba_encode(v, cap):
        raise AssertionError("K6e on the whole tile: the payload differs from akort_manba_encode")
    parts, _ = manba_decode_inputs([payload], v.size, dev)
    got = md.manba_decode_device(*parts, v.size).cpu().numpy()[0]
    if not (np.array_equal(got, v) and np.array_equal(manba_decode(v.size, payload), v)):
        raise AssertionError("K6d on the whole tile: differs from the stream")
    torch.cuda.synchronize()
    log(f"  K6e/K6d whole tile {tuple(whole.shape)}: payload equal to akort_manba_encode, values "
        "equal to the stream (the plain chain, a torch loop over 5.2 M positions, is skipped)")

    # K6d's edge cases, against the plain version reading the whole pool
    edges = k6d_edge_cases(dev)
    for name, parts, n, values in edges:
        got = md.manba_decode_device(*parts, n)
        e = _max_err(got, md.manba_decode_plain(*parts, n))
        err["manba_decode"] = max(err["manba_decode"], e)
        if e or (values is not None and not np.array_equal(got.cpu().numpy(), values)):
            raise AssertionError(f"K6d != plain (or the streams) on {name}: {e}")
    log(f"  K6d edge cases {[name for name, *_ in edges]}: each equal to plain")
    log(f"kernels: K6e and K6d equal to plain on {len(cases)} cases, K6d on {len(edges)} more")
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


def oracle_encode_manba(img, s):
    """Blob of a MANBAVARAN setting from the native runtime alone, per
    tile: the colour transform, the lift (runtime/hostcodec.py) and
    akort_manba_encode, framed as encode frames."""
    from ako_tpu_torch.core import container, geometry
    from ako_tpu_torch.encode import checked_settings, tile_qg, tile_stream_bytes
    from ako_tpu_torch.runtime import hostcodec
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD, manba_encode

    s = checked_settings(s)
    h, w, ch = img.shape
    blocks = [container.head_write(ch, w, h, s)]
    for t in geometry.tile_grid(w, h, s.tiles_dimension):
        planes = hostcodec.u8_to_planes(img[t.y : t.y + t.h, t.x : t.x + t.w], s.color,
                                        bool(s.discard_non_visible))
        qg = tile_qg(t.w, t.h, ch, s.quantization, s.gate, s.chroma_loss)
        payload = manba_encode(hostcodec.tile_lift(planes, s.wavelet, s.wrap, qg),
                               tile_stream_bytes(t, s, ch) - BLOCK_HEAD.size)
        if payload is None:
            raise AssertionError("oracle: incompressible tile")
        blocks.append(BLOCK_HEAD.pack(len(payload)) + payload)
    return b"".join(blocks)


def oracle_decode(blob):
    """Pixels from the native runtime alone: per tile the one-call Kagari
    decode, or for a MANBAVARAN block that holds rANS akort_manba_decode,
    the unlift and the inverse colour transform."""
    from ako_tpu_torch.core import container, geometry
    from ako_tpu_torch.core.settings import Compression
    from ako_tpu_torch.decode import tile_block_sizes
    from ako_tpu_torch.runtime import hostcodec
    from ako_tpu_torch.runtime.hostcodec import tile_decode_block
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD, manba_decode

    view = memoryview(blob)
    ch, w, h, s = container.head_read(view)
    image = np.empty((h, w, ch), np.uint8)
    cursor = container.HEAD_SIZE
    for t in geometry.tile_grid(w, h, s.tiles_dimension):
        (size,) = BLOCK_HEAD.unpack_from(view, cursor)
        payload = view[cursor + BLOCK_HEAD.size : cursor + BLOCK_HEAD.size + size]
        cursor += BLOCK_HEAD.size + size
        tds, spacing = tile_block_sizes(t, s, ch)
        values = None
        if s.compression == Compression.MANBAVARAN:
            values = manba_decode(tds // 2, payload)
        if values is not None:
            pix = hostcodec.planes_to_u8(
                hostcodec.tile_unlift(values, t.w, t.h, ch, s.wavelet, s.wrap), s.color)
        else:
            pix = tile_decode_block(
                payload, tds // 2, tds + spacing, t.w, t.h, ch, s.wavelet, s.wrap, s.color
            )
        if pix is None:
            raise AssertionError("oracle: broken block")
        image[t.y : t.y + t.h, t.x : t.x + t.w] = pix
    return image


def expected_launches(img, settings, device_entropy: bool, mode: str) -> dict:
    """Per shape group: in the fused wiring one lift_level (unlift_level)
    launch per level before pyramid_start (every level when it is None)
    and one lift_pyramid (unlift_pyramid) launch, no K1/K2 call; in the
    split wiring two K1v (K2v) launches per level (the pass along -1, and
    both halves' passes along -2 in one launch); one K3 per shape group
    of a device-entropy encode, one K4 per shape group of its decode, or
    for a MANBAVARAN setting (run under AKO_TPU_MANBAVARAN=1) one K6e and
    one K6d."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.ops.lift_kernels import pyramid_start

    h, w, ch = img.shape
    out = dict.fromkeys(("lift2d", "unlift2d", "vlift", "vunlift", "kagari_encode",
                         "kagari_decode", "lift_pyramid", "unlift_pyramid", "lift_level",
                         "unlift_level", "manba_encode", "manba_decode", "rate_serialize",
                         "rate_sizes", "lift_level_shards", "unlift_level_shards"), 0)
    for name, s in settings.items():
        coder = "manba" if is_manba(name) else "kagari"
        for tw, th in geometry.group_by_shape(geometry.tile_grid(w, h, s.tiles_dimension)):
            schedule = geometry.lift_schedule(tw, th)
            levels = len(schedule.levels)
            if mode == "split":
                out["vlift"] += 2 * levels
                out["vunlift"] += 2 * levels
            else:
                start = pyramid_start(schedule, ch)
                per_level = levels if start is None else start
                out["lift_level"] += per_level
                out["unlift_level"] += per_level
                out["lift_pyramid"] += start is not None
                out["unlift_pyramid"] += start is not None
            out[f"{coder}_encode"] += device_entropy
            out[f"{coder}_decode"] += device_entropy
    return out


def phase_north_star(P, dev, img, oracle) -> dict:
    """Drive each path (encode + decode under each setting) with the
    launch counts reset just before and read just after; then hold every
    blob and image to the native oracle, and the device-entropy paths to
    zero host fallbacks."""
    from ako_tpu_torch.utils import metrics

    settings = {**north_star_settings(P), **manba_settings(P)}
    launches = {}
    for path, device_entropy, mode in PATHS:
        os.environ["AKO_TORCH_LIFT_MODE"] = mode
        metrics.reset()
        reset_launches()
        results = {}
        for name, s in settings.items():
            with manba_env(is_manba(name)):
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
        north = expected_launches(img, {"north_t128": settings["north_t128"]}, device_entropy, mode)
        if mode == "fused" and (north["lift_level"], north["unlift_level"]) != (0, 0):
            raise AssertionError(f"{path}: north_t128 expects per-level launches: {north}")
        if mode == "fused" and (launches[path]["lift2d"], launches[path]["unlift2d"]) != (0, 0):
            raise AssertionError(f"{path}: the fused wiring called K1/K2: {launches[path]}")
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


def _median_ms(fn, runs: int = RUNS) -> float:
    fn()
    times = []
    for _ in range(runs):
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
    """One warm call under torch.profiler: host-clock wall ms (to the
    closing synchronize) and enqueue ms (until the call returns), device
    busy ms (union of device intervals), device ms per kernel, the device
    events' kernels in start order ("order"), and the counts of device
    kernels, device copies, the host's kernel launch calls, host waits for
    the stream (cudaStreamSynchronize, blocking cudaMemcpy) and top-level
    torch ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        enqueue = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    host = [e for e in prof.events() if e.device_type != DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    per: dict = {}
    order = []
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        m = KERNEL_RE.search(name)
        key = m.group(1) if m else ("memcpy" if "Memcpy" in name else "torch ops")
        per[key] = per.get(key, 0.0) + (b - a) / 1e3
        order.append(key)
    copies = sum(1 for _, _, name in spans if "Memcpy" in name)
    return {
        "wall": wall, "enqueue": enqueue, "busy": busy / 1e3, "per": per, "events": len(spans),
        "order": order,
        "kernels": sum(1 for _, _, name in spans if "Memcpy" not in name and "Memset" not in name),
        "copies": copies,
        "launch_calls": sum(1 for e in host if "Launch" in e.name),
        "waits": sum(1 for e in host if e.name in ("cudaStreamSynchronize", "cudaMemcpy")),
        "ops": sum(1 for e in host
                   if e.name.startswith("aten::") and getattr(e, "cpu_parent", None) is None),
    }


def _whole(r: dict) -> bool:
    """Whether a profiled window recorded a device kernel for each of the
    host's kernel launch calls."""
    return r["events"] > 0 and r["kernels"] == r["launch_calls"]


def _profile_until(fn, complete=_whole, tries: int = 3) -> dict:
    """_profile_window(fn) until `complete(window)` holds, at most `tries`
    windows; the last window otherwise. The profiler now and then records
    none of a window's device events, or not all, while the host's record
    of its launch calls is whole: such a window shows nothing about the
    device work, so the caller reads a window that recorded what ran."""
    for i in range(tries):
        r = _profile_window(fn)
        r["windows"] = i + 1
        if complete(r):
            break
    return r


def _enqueue_ms(fn) -> float:
    """Median host ms until fn returns (its device work left queued)."""
    fn()
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _span_ms(fn) -> float:
    """Median device ms between CUDA events recorded just before and just
    after the call: its kernels' time when the host enqueues faster than
    the device runs, else the host's enqueue time."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_streams(P, dev, img, card) -> dict:
    """encode.forward_streams and decode.stream_pixels on the north
    star's 128-px tile group (80 RGBA tiles), in the fused and the split
    wiring, and on the default whole tile (one 1024x1280 tile): median
    host enqueue ms and device span
    (CUDA events), the port's kernel launches per call, and under
    torch.profiler one warm call's device busy ms, wall ms, device ms per
    kernel, device kernels and copies, host waits for the stream and
    top-level torch ops. Uses only what every version of the port has,
    so that it can be imported against an older checkout's package to
    compare; returns {(setting, call): numbers}."""
    from ako_tpu_torch.decode import stream_pixels
    from ako_tpu_torch.encode import checked_settings, forward_streams

    h, w, ch = img.shape
    out = {}
    north = P.Settings(quantization=16, tiles_dimension=128)
    for setting, s, mode in (("north_t128", north, "fused"), ("north_t128_split", north, "split"),
                             ("default_whole", P.Settings(), "fused")):
        os.environ["AKO_TORCH_LIFT_MODE"] = mode
        s = checked_settings(s)
        t = s.tiles_dimension
        tw, th = (t, t) if t else (w, h)
        batch = [img[y : y + th, x : x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
        tiles = torch.from_numpy(np.stack(batch)).to(dev)
        streams = forward_streams(tiles, tw, th, ch, s)
        for name, fn in (("forward_streams", lambda: forward_streams(tiles, tw, th, ch, s)),
                         ("stream_pixels", lambda: stream_pixels(streams, tw, th, ch, s))):
            enqueue = _enqueue_ms(fn)
            span = _span_ms(fn)
            before = sum(all_launches().values())
            fn()
            launches = sum(all_launches().values()) - before
            r = _profile_until(fn)
            per = {k: round(v, 4) for k, v in sorted(r["per"].items())}
            out[(setting, name)] = {"enqueue": enqueue, "span": span, "launches": launches, **r}
            log(f"streams {setting} {name} on {tuple(tiles.shape)}: host enqueue {enqueue:.3f} ms, "
                f"device span {span:.4f} ms (medians of {RUNS}), {launches} port kernel launches; "
                f"profiled call: enqueue {r['enqueue']:.3f} ms, wall {r['wall']:.3f} ms, "
                f"device busy {r['busy']:.4f} ms {per}, {r['kernels']} device kernels, "
                f"{r['copies']} device copies, {r['waits']} host waits for the stream, "
                f"{r['ops']} top-level torch ops [{card}]")
    os.environ.pop("AKO_TORCH_LIFT_MODE")
    return out


def phase_profile(P, dev, img, card) -> dict:
    """Device time per kernel on one warm north-star (128-px tiles)
    encode and decode on each path and on the default whole tile's
    device-entropy path, and K3 alone beside its plain version. Returns
    {kernel: device ms per image} from the run of ROW_RUN."""
    from ako_tpu_torch.ops.kagari_device import kagari_encode_device

    settings = {**north_star_settings(P), **manba_settings(P)}
    per_kernel: dict = {}
    runs = [(*p, "north_t128") for p in PATHS] + [
        ("device_fused", True, "fused", name)
        for name in ("default_whole", "north_t128_manba", "default_whole_manba")]
    for path, device_entropy, mode, setting in runs:
        os.environ["AKO_TORCH_LIFT_MODE"] = mode
        s = settings[setting]
        with manba_env(is_manba(setting)):
            blob = P.encode(img, s, device=dev, device_entropy=device_entropy)
        for direction, fn in (
            ("encode", lambda: P.encode(img, s, device=dev, device_entropy=device_entropy)),
            ("decode", lambda: P.decode(blob, device=dev, device_entropy=device_entropy)),
        ):
            split_kernel = "vlift" if direction == "encode" else "vunlift"
            split_want = 2 * split_levels(img, s) if mode == "split" else None
            with manba_env(is_manba(setting)):
                r = _profile_until(fn, lambda r: _whole(r) and (
                    split_want is None or r["order"].count(split_kernel) == split_want))
            if r["events"] == 0:
                log("profile: the profiler shows no device time; kernel ms come from CUDA "
                    f"events around {KERNEL_ITERS} back-to-back launches")
                return {}
            per = {k: round(v, 4) for k, v in sorted(r["per"].items())}
            log(f"profile {path} {setting} {direction}: wall {r['wall']:.3f} ms, device busy "
                f"{r['busy']:.3f} ms (idle {100 * (1 - r['busy'] / r['wall']):.1f}%); device ms "
                f"{per}; {r['kernels']} device kernels for {r['launch_calls']} launch calls "
                f"(profiled window {r['windows']}) [{card}]")
            for name, k in DEVICE_KERNELS.items():
                if name in r["per"] and ROW_RUN.get(k) == (path, setting):
                    per_kernel[k] = per_kernel.get(k, 0.0) + r["per"][name]
            if mode == "split":
                check_split_order(r["order"], split_kernel, split_want)
    os.environ.pop("AKO_TORCH_LIFT_MODE")

    # K3 alone on the north star's streams and on the whole tile's: one
    # device kernel a call and nothing else on the device (no memset, no
    # torch op): one launch a call by its counter, one launch call on the
    # host, and that one kernel in the window's device events; then its
    # plain version's torch ops
    for setting in ("north_t128", "default_whole"):
        ((streams, cap, budget),) = group_streams(dev, img, settings[setting])
        before = all_launches()["kagari_encode"]
        r = _profile_until(lambda: kagari_encode_device(streams, cap, budget))
        calls = all_launches()["kagari_encode"] - before
        k3 = {n: round(v, 4) for n, v in r["per"].items()
              if DEVICE_KERNELS.get(n) == "kagari_encode"}
        if (r["events"], r["kernels"], r["launch_calls"], list(r["per"])) != (
                1, 1, 1, ["kagari_encode"]):
            raise AssertionError(f"K3 call on {setting}: device work {r['per']} in {r['events']} "
                                 f"events, {r['launch_calls']} launch calls, expected the one "
                                 "kernel")
        if calls != 2 * r["windows"]:  # a warm call and the profiled one a window
            raise AssertionError(f"K3 call on {setting}: {calls} launches in {r['windows']} "
                                 "profiled windows, expected one a call")
        plain = _profile_window(lambda: k3_plain(streams, budget))
        log(f"profile K3 kernel {setting} on {tuple(streams.shape)}: device ms {k3}, "
            f"{r['kernels']} device kernel, {r['events']} device event (profiled window "
            f"{r['windows']}), busy {r['busy']:.4f} ms "
            f"of wall {r['wall']:.3f} ms, enqueue {r['enqueue']:.3f} ms; its plain version (torch "
            f"ops): busy {plain['busy']:.3f} ms in {plain['events']} device events, enqueue "
            f"{plain['enqueue']:.3f} ms [{card}]")
    return {k: round(v, 4) for k, v in per_kernel.items()}


def split_levels(img, s) -> int:
    """Levels an image's split-wiring call lifts, over its shape groups."""
    from ako_tpu_torch.core import geometry

    h, w, _ = img.shape
    return sum(len(geometry.lift_schedule(tw, th).levels)
               for tw, th in geometry.group_by_shape(geometry.tile_grid(w, h, s.tiles_dimension)))


def check_split_order(order: list, kernel: str, want: int) -> None:
    """On the split wiring, a level's K1v (K2v) launches follow one another
    with no device work between them (no transpose or copy): in the
    profiled call's device events, each level's two launches of `kernel`
    are adjacent, and there are `want` (two a level)."""
    at = [i for i, key in enumerate(order) if key == kernel]
    if len(at) != want:
        raise AssertionError(f"split wiring: {len(at)} {kernel} launches in the profile, "
                             f"expected {want}")
    between = [order[a + 1 : b] for a, b in zip(at[::2], at[1::2]) if b != a + 1]
    if between:
        raise AssertionError(f"split wiring: device work between a level's {kernel} launches: "
                             f"{between}")
    log(f"profile split: {len(at)} {kernel} launches, a level's two adjacent with no device work "
        "between them")


def launch_floor_ms(dev, iters: int = 50) -> float:
    """The launch floor: the median device ms of an empty kernel
    (csrc/vlift.cu launch_floor) over `iters` launches back to back on
    the stream, under torch.profiler (which may drop a few events of such
    short kernels: at least half must be there)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ako_tpu_torch.runtime import kernels

    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.launch_floor(stream)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            kernels.launch_floor(stream)
        torch.cuda.synchronize()
    times = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and "launch_floor" in e.name]
    if len(times) < iters // 2:
        raise AssertionError(f"launch floor: {len(times)} device events of {iters} launches")
    return statistics.median(times) / 1e3


def _kernel_ms(fn, name: str, iters: int = 20) -> float:
    """Device ms a call of the kernel `name`, every launch summed (the
    profiler, over `iters` calls; it may drop a few events of short
    kernels, so each instantiation counts its mean event time times its
    events a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        m = KERNEL_RE.search(e.name) if e.device_type == DeviceType.CUDA else None
        if m and m.group(1) == name:
            by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    return sum(sum(t) / len(t) * max(1, round(len(t) / iters)) for t in by_name.values()) / 1e3


def _level_inputs(rng, dev, n, lvl):
    x = _rand16(rng, (n, lvl.current_h, lvl.current_w), dev)
    quads = [_rand16(rng, (n, lvl.target_h, lvl.target_w), dev) for _ in range(4)]
    return x, quads


def kernel_times(P, dev, img, s, card, split: bool) -> dict:
    """Per-level kernel vs plain torch time (CUDA events around
    back-to-back calls, so launch rate for the small levels) for the
    shape groups of one setting, on the levels each wiring sends to them
    (every level split, two K1v (K2v) launches as the wiring makes them,
    with their device ms from the profiler; fused, the levels before
    pyramid_start); returns per-kernel sums over levels."""
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
        schedule = geometry.lift_schedule(tw, th)
        start = None if split else lift_kernels.pyramid_start(schedule, ch)
        for i, lvl in enumerate(schedule.levels[:start]):
            weff = wavelets.effective_wavelet(s.wavelet, lvl.target_w, lvl.target_h)
            n = len(tiles) * ch
            x, quads = _level_inputs(rng, dev, n, lvl)
            if split:
                # the level's K1v (K2v) launches as the split wiring makes
                # them, against the plain versions of the same calls
                def plain_fwd():
                    lp, hp = wavelets.vlift(weff, s.wrap, x, -1)
                    return wavelets.vlift(weff, s.wrap, lp), wavelets.vlift(weff, s.wrap, hp)

                def plain_inv():
                    ll, b, c, d = quads
                    left = wavelets.vunlift(weff, s.wrap, ll, c, lvl.current_h)
                    right = wavelets.vunlift(weff, s.wrap, b, d, lvl.current_h)
                    return wavelets.vunlift(weff, s.wrap, left, right, lvl.current_w, -1)

                def fwd():
                    return lift_kernels.lift2d_level(weff, s.wrap, x, lvl, "split")

                def inv():
                    return lift_kernels.unlift2d_level(weff, s.wrap, *quads, lvl, "split")

                row = {"vlift": (_event_ms(fwd), _event_ms(plain_fwd)),
                       "vunlift": (_event_ms(inv), _event_ms(plain_inv))}
                log(f"  level {i} split {weff.name} n={n} {lvl.current_h}x{lvl.current_w}: "
                    f"K1v {_kernel_ms(fwd, 'vlift'):.4f} ms, K2v {_kernel_ms(inv, 'vunlift'):.4f} "
                    f"ms (device, profiler, two launches each) [{card}]")
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


def k3_times(P, dev, img, card) -> tuple:
    """K3 vs its plain version on the card on the north star's streams
    (CUDA events), and K3 on the whole tile's stream (the profiler's
    median of 20 launches, and CUDA events)."""
    from ako_tpu_torch.ops.kagari_device import kagari_encode_device

    settings = north_star_settings(P)
    ((streams, cap, budget),) = group_streams(dev, img, settings["north_t128"])
    kern = _event_ms(lambda: kagari_encode_device(streams, cap, budget))
    plain = _event_ms(lambda: k3_plain(streams, budget), iters=3)
    log(f"  K3 per image: kernel {kern:.4f} ms (CUDA events, launch included), "
        f"plain {plain:.4f} ms [{card}]")
    ((whole, wcap, wbudget),) = group_streams(dev, img, settings["default_whole"])
    fn = lambda: kagari_encode_device(whole, wcap, wbudget)
    log(f"  K3 whole tile {tuple(whole.shape)}: kernel {_launch_ms(fn, 'kagari_encode'):.4f} ms "
        f"(profiler), {_event_ms(fn):.4f} ms (CUDA events) [{card}]")
    return round(kern, 4), round(plain, 4)


def _once_ms(fn) -> float:
    """Device ms of one call between CUDA events (for the plain chain,
    a torch loop too slow to repeat)."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _host_ms(fn) -> float:
    """Median host-clock ms of fn (the native coder), after one call."""
    fn()
    times = []
    for _ in range(RUNS):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------- K6e's step in SASS

#: the operation chains of csrc/manba_encode.cu manba_op_chain, by K, then
#: manba_load_chains' two (a dependent shared load, a dependent L2 load)
OP_CHAINS = ("imad_hi", "shf", "isetp_sel", "sel", "imad", "alu", "lds", "l2")
OP_CHAIN_LEN = 16  # kOpChain
#: SASS opcodes that write no register
_NO_DEST = ("ST", "RED", "BRA", "BAR", "EXIT", "RET", "CALL", "BSYNC", "BSSY", "WARPSYNC", "NOP",
            "MEMBAR", "ERRBAR", "DEPBAR", "CCTL", "YIELD", "JMP", "BPT", "FENCE")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_REG = re.compile(r"\b(U?R\d+|U?P\d+)(\.64)?\b")


def sass_functions(text: str) -> dict:
    """cuobjdump -sass output -> {function name: [(address, text, control)
    of each instruction, or (None, label, None)]}, control being the
    scheduling bits of the instruction's second word: (stall cycles,
    yield, write barrier, read barrier, wait mask), barrier 7 for none."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            cur.append((None, m.group(1), None))
            continue
        m = _INSN.search(line)
        if m:
            cur.append((int(m.group(1), 16), m.group(2), None))
            continue
        m = re.fullmatch(r"\s*/\* 0x([0-9a-f]{16}) \*/\s*", line)
        if m and cur and cur[-1][0] is not None and cur[-1][2] is None:
            hi = int(m.group(1), 16)
            ctrl = ((hi >> 41) & 0xF, (hi >> 45) & 1, (hi >> 46) & 7, (hi >> 49) & 7,
                    (hi >> 52) & 0x3F)
            cur[-1] = (cur[-1][0], cur[-1][1], ctrl)
    return funcs


def _split_operands(s: str) -> list:
    out, depth, cur = [], 0, ""
    for ch in s:
        depth += ch in "[(" and 1 or 0
        depth -= ch in "])" and 1 or 0
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()] if cur.strip() else out


def _regs(operand: str) -> list:
    regs = []
    for name, wide in _REG.findall(operand):
        regs.append(name)
        if wide:
            regs.append(name[:-len(name.lstrip("UPR"))] + str(int(name.lstrip("UPR")) + 1))
    return regs


def sass_insn(text: str) -> tuple:
    """One SASS instruction -> (opcode, registers written, registers read,
    guarded). A guarded instruction also keeps its destinations' old
    values where its predicate is false; those are not in `read`."""
    guard = re.match(r"@!?(U?P\d+)\s+", text)
    if guard:
        text = text[guard.end():]
    op, _, rest = text.partition(" ")
    ops = _split_operands(rest)
    reads = [guard.group(1)] if guard else []
    writes = []
    if ops and not op.startswith(_NO_DEST):
        width = 4 if ".128" in op else 2 if (".64" in op or "WIDE" in op) else 1
        first = _regs(ops[0])
        if first and width > 1 and first[0].lstrip("U").startswith("R"):
            n = int(first[0].lstrip("UR"))
            first = [first[0][: -len(str(n))] + str(n + i) for i in range(width)]
        writes = first
        k = 1
        while k < len(ops) and re.fullmatch(r"!?U?P(\d+|T)", ops[k]):
            writes += _regs(ops[k])
            k += 1
        ops = ops[k:]
    for o in ops:
        reads += _regs(o)
    return op, writes, reads, bool(guard)


def sass_loops(insns: list, innermost: bool = True) -> list:
    """The innermost loops of a function (every loop when not
    `innermost`): [(start address, end address, [(instruction text,
    control)])], a loop being a branch back (to a label or an address)."""
    labels, pending = {}, []
    for addr, text, _ in insns:
        if addr is None:
            pending.append(text)
        else:
            for lab in pending:
                labels[lab] = addr
            pending = []
    spans = []
    for addr, text, _ in insns:
        m = addr is not None and re.search(r"BRA\S*\s+(?:`?\(?(\.L_x_\d+)|(0x[0-9a-f]+))", text)
        if not m:
            continue
        target = labels.get(m.group(1), addr + 1) if m.group(1) else int(m.group(2), 16)
        if target <= addr:
            spans.append((target, addr))
    inner = [s for s in spans if not innermost or
             not any(o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
    return [(a, b, [(t, c) for ad, t, c in insns if ad is not None and a <= ad <= b])
            for a, b in inner]


def _is_mulhi(op: str) -> bool:
    """A 32-bit multiply-high: IMAD.HI, or IMAD.WIDE.U32 read for its
    high word."""
    return op.startswith(("IMAD.HI", "IMAD.WIDE.U32"))


def op_latency(op: str, lat: dict) -> float:
    """Cycles of one SASS operation on a dependent chain, from the
    measured chains (lat: OP_CHAINS -> cycles; ISETP is the compare and
    select less the select); logic, moves and the other integer ALU
    operations take the add and logic chain's."""
    if _is_mulhi(op):
        return lat["imad_hi"]
    if op.startswith(("IMAD", "IMUL")):
        return lat["imad"]
    if op.startswith("SHF"):
        return lat["shf"]
    if op.startswith("ISETP"):
        return max(lat["isetp_sel"] - lat["sel"], 1.0)
    if op.startswith("SEL"):
        return lat["sel"]
    if op.startswith("LDS"):
        return lat["lds"]
    return lat["alu"]


def dependent_path(body: list, lat: dict, carried: tuple = ()) -> tuple:
    """The longest loop-carried dependent path of a loop body (its
    instructions' text): (cycles, [opcodes on it]). A path starts at a
    register that the body writes and that is live when it starts (the
    state, counters); a load starts a new path that is not carried, so
    the path counts register operations only, but a load whose opcode
    begins with one of `carried` (K6d's table lookup, "LDS") is an
    operation of the path. A guarded instruction
    waits its operation's latency on its sources and one cycle (issue
    order) on the value it may keep, as the compiler schedules it."""
    parsed = [sass_insn(t) for t in body]
    written = {r for _, w, _, _ in parsed for r in w}
    state = {r: (0.0, []) for r in written}  # register -> (cycles, path) while carried
    for op, writes, reads, guarded in parsed:
        srcs = []
        if not op.startswith("LD") or op.startswith(carried):
            srcs = [(c + op_latency(op, lat), p)
                    for c, p in (state[r] for r in reads if r in state)]
            if guarded:
                srcs += [(c + 1.0, p) for c, p in (state[r] for r in writes if r in state)]
        if not srcs:
            for r in writes:
                state.pop(r, None)
            continue
        cyc, path = max(srcs, key=lambda s: s[0])
        new = (cyc, path + ["IMAD.HI" if _is_mulhi(op) else op.split(".")[0]])
        for r in writes:
            state[r] = new
    return max(state.values(), key=lambda s: s[0], default=(0.0, []))


def chain_loop_sass(sass: str, kernel: str, lat: dict) -> dict:
    """The chain loop of `kernel` (the innermost loop with the most
    unguarded multiply-highs, one a step) in cuobjdump's SASS: steps in its body,
    instructions a step, the dependent path a step in operations and in
    cycles (at the measured latencies), the path's opcodes, and the
    compiler's schedule: the stall cycles its control bits set a step
    (issue waits beside those on the scoreboard) and the instructions
    that wait on a scoreboard."""
    funcs = [v for k, v in sass_functions(sass).items() if kernel in k]
    if not funcs:
        raise AssertionError(f"SASS: no function named like {kernel}")
    loops = [lp for f in funcs for lp in sass_loops(f)]
    steps = lambda lp: sum(_is_mulhi(sass_insn(t)[0]) and not t.startswith("@") for t, _ in lp[2])
    lp = max(loops, key=lambda lp: (steps(lp), -len(lp[2])), default=None)
    if lp is None or steps(lp) == 0:
        raise AssertionError(f"SASS: no loop with a multiply-high in {kernel}")
    k = steps(lp)
    body = [t for t, _ in lp[2]]
    ctrl = [c for _, c in lp[2] if c is not None]
    cycles, path = dependent_path(body, lat)
    return {"steps": k, "insns_per_step": len(body) / k, "path_ops_per_step": len(path) / k,
            "path_cycles_per_step": cycles / k, "path": path, "span": (hex(lp[0]), hex(lp[1])),
            "stall_cycles_per_step": sum(c[0] for c in ctrl) / k if ctrl else None,
            "scoreboard_waits_per_step": sum(c[4] != 0 for c in ctrl) / k if ctrl else None}


#: K6d's kernel in the library's SASS (its mangled name's part)
K6D_SASS_NAME = "12manba_decodeE"


def decode_loop_sass(sass: str, kernel: str, lat: dict) -> dict:
    """K6d's chain loop in cuobjdump's SASS: the loop of `kernel` with the
    most 32-bit shared-memory loads (one table lookup a step; a 16-byte one
    reads the outputs' buffer) that also loads device memory (the windows'
    words), without the loops nested in it (the cold tail of a row's
    stores); its steps the table lookups. Returns chain_loop_sass's
    account, the dependent path through the table lookup (at lat["lds"]
    cycles) and the register operations."""
    funcs = [v for k, v in sass_functions(sass).items() if kernel in k]
    if not funcs:
        raise AssertionError(f"SASS: no function named like {kernel}")
    lookups = lambda body: sum(sass_insn(t)[0] == "LDS" for t, _ in body)
    loops = []
    for f in funcs:
        every = sass_loops(f, innermost=False)
        for a, b, body in every:
            nested = [(c, d) for c, d, _ in every if (c, d) != (a, b) and a <= c and d <= b]
            addrs = [ad for ad, t, _ in f if ad is not None and a <= ad <= b and
                     not any(c <= ad <= d for c, d in nested)]
            own = [(t, c) for ad, t, c in f if ad in set(addrs)]
            if lookups(own) and any(sass_insn(t)[0].startswith("LDG") for t, _ in own):
                loops.append((a, b, own))
    if not loops:
        raise AssertionError(f"SASS: no loop of {kernel} with table and window loads")
    lp = max(loops, key=lambda lp: (lookups(lp[2]), -len(lp[2])))
    k = lookups(lp[2])
    body = [t for t, _ in lp[2]]
    ctrl = [c for _, c in lp[2] if c is not None]
    cycles, path = dependent_path(body, lat, carried=("LDS",))
    return {"steps": k, "insns_per_step": len(body) / k, "path_ops_per_step": len(path) / k,
            "path_cycles_per_step": cycles / k, "path": path, "span": (hex(lp[0]), hex(lp[1])),
            "stall_cycles_per_step": sum(c[0] for c in ctrl) / k if ctrl else None,
            "scoreboard_waits_per_step": sum(c[4] != 0 for c in ctrl) / k if ctrl else None}


def cuobjdump_sass(lib: str) -> str:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([exe, "-sass", lib], capture_output=True, text=True, timeout=300)
    if res.returncode:
        raise RuntimeError(f"cuobjdump -sass {lib} failed: {res.stderr[-2000:]}")
    return res.stdout


def op_latencies(lib=None, iters: int = 4096) -> dict:
    """Cycles per operation of the chains of ako_manba_op_latency (one
    thread, iters x 16 dependent operations each, clock64) on the card:
    the six of manba_op_chain, a shared-memory load (K6d's table lookup)
    and a device-memory load served by L2 (its set-up's loads of a buffer
    just uploaded)."""
    from ako_tpu_torch.runtime import kernels

    out = torch.zeros(2 * len(OP_CHAINS), dtype=torch.int64, device="cuda")
    ring = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")
    fn = lib.ako_manba_op_latency if lib is not None else kernels.load().ako_manba_op_latency
    for _ in range(2):  # the first call warms the instruction cache
        rc = fn(out.data_ptr(), ring.data_ptr(), ring.numel(), iters,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ako_manba_op_latency: cudaError {rc}")
    torch.cuda.synchronize()
    cyc = out.cpu().numpy()[1::2]
    return {k: float(c) / (iters * OP_CHAIN_LEN) for k, c in zip(OP_CHAINS, cyc)}


def chain_alone(lib, values, record) -> dict:
    """K6e's chain alone (ako_manba_chain_alone) on one stream (1-D int16
    on the card) with its K6e record: the final state (checked against
    the record), and cycles, ns and GHz a step from the card's own clocks
    (the median of three runs after one)."""
    out = torch.zeros(3, dtype=torch.int64, device=values.device)
    runs = []
    for _ in range(4):
        rc = lib.ako_manba_chain_alone(values.data_ptr(), values.numel(), record.data_ptr(),
                                       out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"ako_manba_chain_alone: cudaError {rc}")
        torch.cuda.synchronize()
        runs.append(out.cpu().numpy().copy())
    x, want = int(runs[-1][0]), int(np.uint32(record.cpu().numpy()[17]))
    if x != want:
        raise AssertionError(f"chain alone: final state {x}, the K6e record's {want}")
    n = values.numel()
    cyc = statistics.median(float(r[1]) for r in runs[1:]) / n
    ns = statistics.median(float(r[2]) for r in runs[1:]) / n
    return {"cycles_per_step": cyc, "ns_per_step": ns, "ghz": cyc / ns}


def k6_step_bound(P, dev, img, card) -> tuple:
    """K6e's step on the card: the operations' latencies (manba_op_chain),
    the chain loop of manba_chain_pack in the library's SASS (cuobjdump:
    instructions and the dependent path a step), and the chain alone on
    the north star's tile 0 stream (manba_chain_alone: cycles, ns and the
    SM clock a step). Returns the step's least time in ns (the longer of
    the dependent path's cycles and the instructions issued a step, one a
    cycle, over the clock), the clock in GHz and the latencies."""
    from ako_tpu_torch.ops import manba_device as md
    from ako_tpu_torch.runtime import kernels

    lat = op_latencies()
    step = chain_loop_sass(cuobjdump_sass(kernels._LIB), "manba_chain_pack", lat)
    ((streams, cap, _),) = group_streams(dev, img, north_star_settings(P)["north_t128"])
    record, _, _ = md.manba_encode_device(streams[:1].contiguous(), cap)
    alone = chain_alone(kernels.load(), streams[0].contiguous(), record[0])
    bound = max(step["path_cycles_per_step"], step["insns_per_step"]) / alone["ghz"]
    log(f"  K6e step: operation latencies (cycles) { {k: round(v, 3) for k, v in lat.items()} }; "
        f"SASS chain loop {step['steps']} steps, {step['insns_per_step']:.2f} instructions a step, "
        f"dependent path {step['path_ops_per_step']:.2f} operations / "
        f"{step['path_cycles_per_step']:.2f} cycles a step ({' '.join(step['path'][:6])} ...), "
        f"scheduled stalls {step['stall_cycles_per_step']:.2f} cycles a step; "
        f"chain alone on tile 0 ({streams.shape[1]} steps): {alone['cycles_per_step']:.2f} cycles, "
        f"{alone['ns_per_step']:.3f} ns a step at {alone['ghz']:.3f} GHz; latency bound "
        f"{bound:.3f} ns a step [{card}]")
    return bound, alone["ghz"], lat


def k6d_latency_bound(name, card, ghz, lat, step=None) -> tuple:
    """K6d's least time: each lane's chain of DECODE_BLOCK steps at the
    dependent path a step of the chain loop in the library's SASS (through
    the table's shared load, at the measured latencies `lat`), after the
    set-up's two dependent round trips (the records, then the windows'
    words: L2 loads), at `ghz`, the SM clock of K6e's chain alone. The
    loop's instructions, which hold both store routes (a launch runs one),
    are logged and not counted. Returns (ms, the SASS account)."""
    from ako_tpu_torch.ops.manba_device import DECODE_BLOCK
    from ako_tpu_torch.runtime import kernels

    step = step or decode_loop_sass(cuobjdump_sass(kernels._LIB), K6D_SASS_NAME, lat)
    per_step = step["path_cycles_per_step"]
    cycles = DECODE_BLOCK * per_step + 2 * lat["l2"]
    bound = cycles / ghz / 1e6
    log(f"  K6d {name}: latencies (cycles) LDS {lat['lds']:.2f}, L2 {lat['l2']:.1f}, ALU "
        f"{lat['alu']:.2f}, IMAD {lat['imad']:.2f}; SASS chain loop {step['steps']} steps, "
        f"{step['insns_per_step']:.2f} instructions a step (both store routes), dependent path "
        f"{step['path_ops_per_step']:.2f} operations / {per_step:.2f} cycles a "
        f"step ({' '.join(step['path'][: round(step['path_ops_per_step'])])}), scheduled stalls "
        f"{step['stall_cycles_per_step']:.2f} cycles a step; latency bound {DECODE_BLOCK} x "
        f"{per_step:.2f} + 2 x {lat['l2']:.1f} cycles at {ghz:.3f} GHz = {bound:.5f} ms [{card}]")
    return bound, step


def k6_times(P, dev, img, card) -> tuple:
    """K6e and K6d on the north star's 80 streams (q=16, 128-px tiles)
    and on the whole tile's stream: the kernels' device ms (the
    profiler's median of 20 calls, each kernel of K6e summed; CUDA events
    around 5 and 50 calls), the plain versions' (one call: the chain is a
    torch loop over positions; skipped on the whole tile), the native
    coder's host ms for the same streams (one thread, tile after tile),
    and K6e's latency bound: the steps of one chain times the step's
    least time (k6_step_bound), and K6d's (k6d_latency_bound). Returns
    ({kernel: (kernel ms, plain ms)} on the north star, {kernel: its
    latency bound ms there})."""
    from ako_tpu_torch.ops import manba_device as md
    from ako_tpu_torch.runtime.kagari import manba_decode, manba_encode

    out = {}
    step_ns, ghz, lat = k6_step_bound(P, dev, img, card)
    k6d_step = None
    for name in ("north_t128", "default_whole"):
        ((streams, cap, _),) = group_streams(dev, img, north_star_settings(P)[name])
        values = streams.cpu().numpy()
        enc = lambda: md.manba_encode_device(streams, cap)
        parts, spans = manba_decode_inputs(manba_payloads(*enc(), cap), values.shape[1], dev)
        dec = lambda: md.manba_decode_device(*parts, values.shape[1])
        launches = {k: _launch_ms(enc, k, iters=20 if name == "north_t128" else 5)
                    for k in ("manba_stats", "manba_model", "manba_chain_pack")}
        k_enc = sum(launches.values())
        k_dec = _launch_ms(dec, "manba_decode")
        e_enc, e_dec = _event_ms(enc, iters=5), _event_ms(dec)
        payloads = [manba_encode(v, cap) for v in values]
        n_enc = _host_ms(lambda: [manba_encode(v, cap) for v in values])
        n_dec = _host_ms(lambda: [manba_decode(values.shape[1], p) for p in payloads])
        steps = values.shape[1]
        latency = steps * step_ns / 1e6
        k6d_bound, k6d_step = k6d_latency_bound(name, card, ghz, lat, k6d_step)
        line = (f"  K6e {name} {tuple(streams.shape)}: kernel {k_enc:.4f} ms (profiler, launches "
                f"{ {k: round(v, 4) for k, v in launches.items()} }), {e_enc:.4f} ms (CUDA events); "
                f"in situ {launches['manba_chain_pack'] * 1e6 / steps:.3f} ns a step; latency "
                f"bound {steps} steps x {step_ns:.3f} ns = {latency:.4f} ms; K6d: {k_dec:.4f} ms "
                f"(profiler), {e_dec:.4f} ms (CUDA events), latency bound {k6d_bound:.5f} ms; "
                f"native coder on the host: encode "
                f"{n_enc:.3f} ms, decode {n_dec:.3f} ms")
        if name == "north_t128":
            p_enc = _once_ms(lambda: md.manba_encode_plain(streams, cap))
            p_dec = _once_ms(lambda: md.manba_decode_plain(*parts, values.shape[1],
                                                           md.DECODE_BLOCK, *spans))
            line += f"; plain: encode {p_enc:.2f} ms, decode {p_dec:.2f} ms"
            out = {"manba_encode": (round(k_enc, 4), round(p_enc, 4)),
                   "manba_decode": (round(k_dec, 4), round(p_dec, 4))}
            north_latency = {"manba_encode": latency, "manba_decode": k6d_bound}
        log(line + f" [{card}]")
    return out, north_latency


def bounds_ms(img, blob, manba_blob) -> dict:
    """Least time per north-star image for each kernel on the run of
    ROW_RUN (128-px tiles; K1/K2 and lift_level / unlift_level: the whole
    tile's levels before pyramid_start): {kernel: (ms, "bytes" or
    "operations")}, the larger of
    the bytes it must move (each input read once, each output written
    once) over the card's memory rate and its integer operations over the
    32-bit scalar rate."""
    from ako_tpu_torch.core import container, geometry
    from ako_tpu_torch.encode import pack_budget
    from ako_tpu_torch.ops.kagari_device import DECODE_BLOCK
    from ako_tpu_torch.ops.lift_kernels import pyramid_start
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD

    h, w, ch = img.shape
    t = 128
    n = (h // t) * (w // t) * ch
    b = {"lift2d": 0, "vlift": 0}
    # the pyramids: the u8 tiles and the int16 streams, each once
    b["lift_pyramid"] = n // ch * t * t * ch + n // ch * geometry.tile_data_size(t, t) * ch
    ops = dict.fromkeys(b, 0)
    for lvl in geometry.lift_schedule(t, t).levels:
        plane = lvl.current_h * lvl.current_w
        # the split wiring's V-only calls: (h, w) -> 2x (h, w/2) along -1,
        # then 2x (h, w/2) -> 4x (h/2, w/2) along -2
        b["vlift"] += n * 2 * (plane + 2 * lvl.current_h * lvl.target_w) * 2
        # one 1-D lift along each axis of the plane
        ops["vlift"] += n * plane * 2 * LIFT_OPS
    ops["lift_pyramid"] = ops["vlift"]
    # K1/K2: the whole tile's planes before pyramid_start (one per channel)
    # and their four quadrants, once each
    whole = geometry.lift_schedule(w, h)
    for lvl in whole.levels[: pyramid_start(whole, ch)]:
        plane = lvl.current_h * lvl.current_w
        b["lift2d"] += ch * 2 * (plane + 4 * lvl.target_h * lvl.target_w)
        ops["lift2d"] += ch * plane * 2 * LIFT_OPS
    # lift_level / unlift_level: the u8 tile read once, the levels' q
    # heads and C, B, D before pyramid_start written once, and the LL at
    # pyramid_start (the LP planes when it is None) written once
    start = pyramid_start(whole, ch)
    before = whole.levels[: len(whole.levels) if start is None else start]
    ll_at = (whole.lp_h * whole.lp_w if start is None or start == len(whole.levels)
             else whole.levels[start].current_h * whole.levels[start].current_w)
    b["lift_level"] = (h * w * ch + 2 * ch * sum(1 + 3 * lvl.target_h * lvl.target_w for lvl in before)
                       + 2 * ch * ll_at)
    ops["lift_level"] = sum(ch * lvl.current_h * lvl.current_w * 2 * LIFT_OPS for lvl in before)
    for k, same in (("unlift2d", "lift2d"), ("vunlift", "vlift"), ("unlift_pyramid", "lift_pyramid"),
                    ("unlift_level", "lift_level")):
        b[k], ops[k] = b[same], ops[same]
    # K4: the compressed payloads, the base words and the sync records
    # (four int32 each) in, the int16 streams out
    tiles = len(geometry.tile_grid(w, h, t))
    count = geometry.tile_data_size(t, t) * ch // 2
    payload = len(blob) - container.HEAD_SIZE - BLOCK_HEAD.size * tiles
    records = tiles * -(-count // DECODE_BLOCK)
    b["kagari_decode"] = payload + 4 * tiles + 16 * records + 2 * tiles * count
    ops["kagari_decode"] = tiles * count * K4_OPS
    # K3: the int16 streams in, the (T, budget) rows and the totals out
    budget = pack_budget(2 * count - BLOCK_HEAD.size, 16)
    b["kagari_encode"] = 2 * tiles * count + tiles * budget + 8 * tiles
    ops["kagari_encode"] = tiles * count * K3_OPS
    # K6e: the int16 streams in, the payloads' rANS and extras bytes and
    # the records out; K6d: the payloads and the sync records (x, rANS
    # byte, extras bit a block; base, ends and 17 freqs a tile) in, the
    # int16 streams out
    manba_payload = len(manba_blob) - container.HEAD_SIZE - BLOCK_HEAD.size * tiles
    b["manba_encode"] = 2 * tiles * count + manba_payload + 4 * 21 * tiles
    ops["manba_encode"] = tiles * count * K6E_OPS
    b["manba_decode"] = manba_payload + 4 * 20 * tiles + 12 * records + 2 * tiles * count
    ops["manba_decode"] = tiles * count * K6D_OPS
    out = {}
    for k in b:
        by_bytes, by_ops = b[k] / HBM_BYTES_PER_S * 1e3, ops[k] / int_ops_per_s() * 1e3
        out[k] = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    return out


def phase_timings(P, dev, img, card) -> dict:
    mp = img.shape[0] * img.shape[1] / 1e6
    settings = {**north_star_settings(P), **manba_settings(P)}
    for (path, device_entropy, mode), (name, s) in itertools.product(PATHS, settings.items()):
        if mode == "split" and name != "north_t128":
            continue
        os.environ["AKO_TORCH_LIFT_MODE"] = mode
        with manba_env(is_manba(name)):
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
    log("kernel times, default_whole, the levels before pyramid_start (sum over levels):")
    per_level = kernel_times(P, dev, img, settings["default_whole"], card, split=False)
    log(f"  default_whole: {per_level} (kernel ms, plain ms)")
    levels = level_times(P, dev, img, settings["default_whole"], card)
    log(f"  default_whole level kernels: {levels} (kernel ms, plain ms)")
    log("kernel times, north_t128 split wiring (sum over levels):")
    split = kernel_times(P, dev, img, settings["north_t128"], card, split=True)
    log(f"  north_t128 split: {split} (kernel ms, plain ms)")
    pyramid = {}
    for name in ("north_t128", "default_whole"):
        pyramid[name] = pyramid_times(dev, img, settings[name], card)
        log(f"  {name} pyramids: {pyramid[name]} (kernel ms, plain ms)")
    pyramid_breakdown(dev, img, settings["north_t128"], card)
    return {**per_level, **split, **pyramid["north_t128"], **levels}


def level_times(P, dev, img, s, card) -> dict:
    """lift_level / unlift_level against their plain versions (CUDA events
    around back-to-back calls of forward_levels / inverse_levels) on the
    levels of one whole-image tile before its pyramid_start, on the image
    and its streams; and each level's device ms (profiler)."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import checked_settings, tile_qg
    from ako_tpu_torch.ops import lift_kernels as lk

    s = checked_settings(s)
    h, w, ch = img.shape
    schedule = geometry.lift_schedule(w, h)
    start = lk.pyramid_start(schedule, ch)
    levels = range(len(schedule.levels) if start is None else start)
    qg = tuple(tile_qg(w, h, ch, s.quantization, s.gate, s.chroma_loss))
    x = torch.from_numpy(np.ascontiguousarray(img[None])).to(dev)
    stream = torch.zeros((1, schedule.coeff_count(ch)), dtype=torch.int16, device=dev)
    fwd = (s.wavelet, s.wrap, qg, s.color, bool(s.discard_non_visible))
    inv = (s.wavelet, s.wrap, ch, s.color)
    ll = lk.forward_levels(x, stream, schedule, levels, *fwd)
    row = {
        "lift_level": (
            _event_ms(lambda: lk.forward_levels(x, stream, schedule, levels, *fwd)),
            _event_ms(lambda: lk.forward_levels_plain(x, stream, schedule, levels, *fwd), iters=5),
        ),
        "unlift_level": (
            _event_ms(lambda: lk.inverse_levels(ll, stream, schedule, levels, *inv)),
            _event_ms(lambda: lk.inverse_levels_plain(ll, stream, schedule, levels, *inv),
                      iters=5),
        ),
    }
    xs = [x]
    for k in levels:
        xs.append(lk.lift_level(xs[-1], stream, schedule, k, *fwd))
    for k in levels:
        lvl = schedule.levels[k]
        region = lk.level_region(schedule, k, ch, s.wavelet, 1, lk.sm_count(dev))
        fw = _launch_ms(lambda: lk.lift_level(xs[k], stream, schedule, k, *fwd), "lift_level")
        iv = _launch_ms(lambda: lk.unlift_level(xs[k + 1], stream, schedule, k, *inv),
                        "unlift_level")
        log(f"  level {k} {lvl.current_h}x{lvl.current_w}x{ch} region {region}: lift_level "
            f"{fw:.4f} ms, unlift_level {iv:.4f} ms (profiler) [{card}]")
    return {k: (round(v[0], 4), round(v[1], 4)) for k, v in row.items()}


def _launch_ms(fn, name: str, iters: int = 20) -> float:
    """Median device ms of the kernel `name` over `iters` launches under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and KERNEL_RE.search(e.name)
             and KERNEL_RE.search(e.name).group(1) == name]
    return statistics.median(times) / 1e3 if times else float("nan")


def pyramid_breakdown(dev, img, s, card) -> None:
    """Where the pyramid kernels' time goes on the north star's 128-px
    group: device ms (profiler) launched from each start level (the
    difference of two starts is a level's share) and, from level 0, for
    1, 8, 40 and 80 tiles (one tile alone is one block's serial chain;
    80 tiles load every SM)."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import checked_settings, tile_qg
    from ako_tpu_torch.ops import lift_kernels as lk

    s = checked_settings(s)
    t = s.tiles_dimension
    h, w, ch = img.shape
    schedule = geometry.lift_schedule(t, t)
    qg = tuple(tile_qg(t, t, ch, s.quantization, s.gate, s.chroma_loss))
    tiles = torch.from_numpy(np.stack([img[y : y + t, x : x + t] for y in range(0, h, t)
                                       for x in range(0, w, t)])).to(dev)
    fwd = (s.wavelet, s.wrap, qg, s.color, bool(s.discard_non_visible))
    inv = (s.wavelet, s.wrap, ch, s.color)
    rng = np.random.default_rng(5)

    def row(x, start):
        stream = torch.zeros((x.shape[0], schedule.coeff_count(ch)), dtype=torch.int16, device=dev)
        lift = _launch_ms(lambda: lk.forward_pyramid(x, stream, schedule, start, *fwd),
                          "lift_pyramid")
        unlift = _launch_ms(lambda: lk.inverse_pyramid(stream, schedule, start, *inv),
                            "unlift_pyramid")
        return f"lift_pyramid {lift:.4f} ms, unlift_pyramid {unlift:.4f} ms"

    for start in range(len(schedule.levels) + 1):
        x = tiles if start == 0 else _rand16(
            rng, (tiles.shape[0], ch, *lk._start_shape(schedule, start)), dev)
        log(f"  pyramids from level {start}, {tiles.shape[0]} tiles: {row(x, start)} [{card}]")
    for n in (1, 8, 40):
        log(f"  pyramids from level 0, {n} tiles: {row(tiles[:n].contiguous(), 0)} [{card}]")


def pyramid_times(dev, img, s, card) -> dict:
    """lift_pyramid / unlift_pyramid against their plain versions (CUDA
    events around back-to-back calls) on the shape groups of one setting,
    each from its pyramid_start; the inverse on the forward's streams."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import checked_settings, tile_qg
    from ako_tpu_torch.ops import lift_kernels as lk

    s = checked_settings(s)
    h, w, ch = img.shape
    rng = np.random.default_rng(4)
    total = {"lift_pyramid": [0.0, 0.0], "unlift_pyramid": [0.0, 0.0]}
    grid = geometry.tile_grid(w, h, s.tiles_dimension)
    for (tw, th), tiles in geometry.group_by_shape(grid).items():
        schedule = geometry.lift_schedule(tw, th)
        start = lk.pyramid_start(schedule, ch)
        qg = tuple(tile_qg(tw, th, ch, s.quantization, s.gate, s.chroma_loss))
        n = len(tiles)
        if start == 0:
            x = torch.from_numpy(np.stack([img[t.y : t.y + th, t.x : t.x + tw] for t in tiles]))
            x = x.to(dev)
        else:
            x = _rand16(rng, (n, ch, *lk._start_shape(schedule, start)), dev)
        stream = torch.zeros((n, schedule.coeff_count(ch)), dtype=torch.int16, device=dev)
        fwd = (s.wavelet, s.wrap, qg, s.color, bool(s.discard_non_visible))
        inv = (s.wavelet, s.wrap, ch, s.color)
        lk.forward_pyramid(x, stream, schedule, start, *fwd)
        row = {
            "lift_pyramid": (
                _event_ms(lambda: lk.forward_pyramid(x, stream, schedule, start, *fwd)),
                _event_ms(lambda: lk.forward_pyramid_plain(x, stream, schedule, start, *fwd),
                          iters=5),
            ),
            "unlift_pyramid": (
                _event_ms(lambda: lk.inverse_pyramid(stream, schedule, start, *inv)),
                _event_ms(lambda: lk.inverse_pyramid_plain(stream, schedule, start, *inv),
                          iters=5),
            ),
        }
        for k, (kern, plain) in row.items():
            total[k][0] += kern
            total[k][1] += plain
            log(f"  {k} {n} tiles {tw}x{th}x{ch} from level {start}: kernel {kern:.4f} ms, "
                f"plain {plain:.4f} ms [{card}]")
    return {k: (round(v[0], 4), round(v[1], 4)) for k, v in total.items()}


# ------------------------------------------------------------ executor

STREAM_N = 12  # bench.py's stream: corpus(42, 12, 1280, 1024, 4)
STREAM_RUNS = 5  # timed turns per stream figure, after a warm-up turn
LATENCY_RUNS = 20  # single-image calls per latency figure
WORKERS = 4  # bench.py's PipelineEncoder / PipelineDecoder workers


def _executor_check(name, blobs, pixels, want, launches, want_launches, fallbacks, want_fb):
    """Every blob byte-equal and every image bit-equal to the native
    oracle, the launches exact and the fallbacks as expected."""
    if len(blobs) != len(want) or len(pixels) != len(want):
        raise AssertionError(f"executor {name}: {len(blobs)} blobs and {len(pixels)} images for "
                             f"{len(want)} inputs")
    for i, (blob, pix, (want_blob, want_pix)) in enumerate(zip(blobs, pixels, want)):
        if blob != want_blob:
            raise AssertionError(f"executor {name}: image {i}'s blob differs from the native "
                                 "oracle")
        if not np.array_equal(pix, want_pix):
            raise AssertionError(f"executor {name}: image {i}'s pixels differ from the native "
                                 "oracle")
    if launches != want_launches:
        raise AssertionError(f"executor {name}: launch counts {launches}, expected "
                             f"{want_launches}")
    if fallbacks != want_fb:
        raise AssertionError(f"executor {name}: fallbacks {fallbacks}, expected {want_fb}")
    log(f"executor {name}: {len(want)} blobs and images equal to the native oracle; launches "
        f"{ {k: v for k, v in launches.items() if v} } (expected); fallbacks {fallbacks}")


def _times_launches(per_image: dict, n: int) -> dict:
    return {k: n * v for k, v in per_image.items()}


def _stream_profile(fn) -> dict:
    """One warm call of fn under torch.profiler: wall and device busy ms,
    the CUDA streams the codec's kernels ran on, and the host<->device
    copies by kind (CUPTI names them "Memcpy HtoD (Pinned -> Device)",
    "... (Pageable -> Device)", and so on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    host = [e for e in prof.events() if e.device_type != DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev_events):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    copies: dict = {}
    streams: set = set()
    kernels = 0
    for e in dev_events:
        if "Memcpy" in e.name:
            copies[e.name] = copies.get(e.name, 0) + 1
        elif "Memset" not in e.name:
            kernels += 1
            if KERNEL_RE.search(e.name):
                streams.add(e.device_resource_id)
    return {"wall": wall, "busy": busy / 1e3, "streams": streams, "copies": copies,
            "events": len(dev_events), "kernels": kernels,
            "launch_calls": sum(1 for e in host if "Launch" in e.name)}


def phase_executor(P, dev, card) -> dict:
    """runtime/executor.py on the card: bench.py's 12-image stream at
    north_t128 through PipelineEncoder / PipelineDecoder (sequential) and
    roundtrip_iter, default_whole_manba at 4 images, and the host modes
    (AKO_TPU_ENCODE=host, AKO_TPU_DECODE=host) at north_t128: blobs and
    pixels held to the native oracle, launches exact (N times one image's
    expected_launches), no host fallback. Then over one warm sequential
    stream under torch.profiler: the codec's kernels on more than one CUDA
    stream, no pageable copy, and the device busy share; the stream MP/s of
    both executor modes against a one-shot P.encode / P.decode loop over
    the same images (medians of 5 turns after a warm-up), and single-image
    p50 / p95 latency."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.runtime.executor import PipelineDecoder, PipelineEncoder, roundtrip_iter
    from ako_tpu_torch.utils import metrics
    from ako_tpu_torch.utils.corpus import corpus

    t0 = time.perf_counter()
    images = corpus(NORTH_STAR["seed"], STREAM_N, NORTH_STAR["h"], NORTH_STAR["w"],
                    NORTH_STAR["ch"])
    s = north_star_settings(P)["north_t128"]
    want = [(b, oracle_decode(b)) for b in (oracle_encode(img, s) for img in images)]
    n, mp = len(images), images[0].shape[0] * images[0].shape[1] / 1e6
    per_image = expected_launches(images[0], {"north_t128": s}, True, "fused")
    tiles = sum(len(geometry.tile_grid(img.shape[1], img.shape[0], s.tiles_dimension))
                for img in images)
    device_fb = {metrics.ENC_DEVICE: tiles, metrics.ENC_HOST_FALLBACK: 0,
                 metrics.DEC_DEVICE: tiles, metrics.DEC_HOST_FALLBACK: 0}
    log(f"executor: {n} images of {images[0].shape}, oracle made in "
        f"{time.perf_counter() - t0:.1f} s; os.cpu_count() = {os.cpu_count()}")

    enc = PipelineEncoder(s, workers=WORKERS, device=dev)
    dec = PipelineDecoder(workers=WORKERS, device=dev)
    list(dec.decode_iter(enc.encode_batch(images[:2])))  # warm: pinned buffers, K3's scratch
    metrics.reset()
    reset_launches()
    blobs = enc.encode_batch(images)
    pixels = list(dec.decode_iter(blobs))
    _executor_check("sequential north_t128", blobs, pixels, want, all_launches(),
                    _times_launches(per_image, n), metrics.fallback_summary(), device_fb)

    metrics.reset()
    reset_launches()
    pairs = list(roundtrip_iter(images, s, workers=WORKERS, device=dev))
    _executor_check("roundtrip north_t128", [b for b, _ in pairs], [p for _, p in pairs], want,
                    all_launches(), _times_launches(per_image, n), metrics.fallback_summary(),
                    device_fb)

    m = manba_settings(P)["default_whole_manba"]
    whole = images[:4]
    want_m = [(b, oracle_decode(b)) for b in (oracle_encode_manba(img, m) for img in whole)]
    with manba_env():
        metrics.reset()
        reset_launches()
        blobs_m = PipelineEncoder(m, workers=WORKERS, device=dev).encode_batch(whole)
        pixels_m = list(PipelineDecoder(workers=WORKERS, device=dev).decode_iter(blobs_m))
        launches_m = all_launches()
    m_launches = _times_launches(
        expected_launches(whole[0], {"default_whole_manba": m}, True, "fused"), len(whole))
    _executor_check("sequential default_whole_manba", blobs_m, pixels_m, want_m, launches_m,
                    m_launches, metrics.fallback_summary(),
                    {metrics.ENC_DEVICE: len(whole), metrics.ENC_HOST_FALLBACK: 0,
                     metrics.DEC_DEVICE: len(whole), metrics.DEC_HOST_FALLBACK: 0})

    for var in ("AKO_TPU_ENCODE", "AKO_TPU_DECODE"):
        os.environ[var] = "host"
    try:
        metrics.reset()
        reset_launches()
        t = time.perf_counter()
        blobs_h = PipelineEncoder(s, workers=WORKERS, device=dev).encode_batch(images)
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        pixels_h = list(PipelineDecoder(workers=WORKERS, device=dev).decode_iter(blobs_h))
        t_dec = time.perf_counter() - t
        _executor_check("host modes north_t128", blobs_h, pixels_h, want, all_launches(),
                        dict.fromkeys(per_image, 0), metrics.fallback_summary(),
                        dict.fromkeys(device_fb, 0))
        log(f"executor host modes north_t128, one pass: encode {t_enc * 1e3:.1f} ms, decode "
            f"{t_dec * 1e3:.1f} ms for {n} images ({n * mp / (t_enc + t_dec):.2f} MP/s; "
            f"{WORKERS} workers, no device work) [{card}]")
    finally:
        for var in ("AKO_TPU_ENCODE", "AKO_TPU_DECODE"):
            os.environ.pop(var)

    # one warm sequential stream under the profiler
    def stream():
        list(dec.decode_iter(enc.encode_iter(images)))

    for window in range(1, 4):
        r = _stream_profile(stream)
        if r["events"] and r["kernels"] == r["launch_calls"]:
            break
    pageable = {k: v for k, v in r["copies"].items() if "Pageable" in k}
    log(f"executor profile, one warm sequential stream of {n} (window {window}): wall "
        f"{r['wall']:.1f} ms, device busy {r['busy']:.1f} ms ({100 * r['busy'] / r['wall']:.1f}%, "
        f"idle {100 * (1 - r['busy'] / r['wall']):.1f}%); {r['kernels']} device kernels for "
        f"{r['launch_calls']} launch calls; the codec's kernels on {len(r['streams'])} CUDA "
        f"streams; copies {r['copies']} [{card}]")
    if not r["events"]:
        raise AssertionError("executor profile: the profiler recorded no device event")
    if len(r["streams"]) < 2:
        raise AssertionError(f"executor profile: the codec's kernels ran on streams "
                             f"{r['streams']}, expected more than one")
    if pageable:
        raise AssertionError(f"executor profile: pageable copies on the device-entropy path: "
                             f"{pageable}")

    # stream rates, in turns: one-shot loop, sequential, roundtrip
    def one_shot():
        t = time.perf_counter()
        out = [P.encode(img, s, device=dev) for img in images]
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        for blob in out:
            P.decode(blob, device=dev)
        return t_enc, time.perf_counter() - t

    def sequential(workers):
        e = PipelineEncoder(s, workers=workers, device=dev)
        d = PipelineDecoder(workers=workers, device=dev)
        t = time.perf_counter()
        out = e.encode_batch(images)
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        list(d.decode_iter(out))
        return t_enc, time.perf_counter() - t

    def roundtrip(workers):
        t = time.perf_counter()
        list(roundtrip_iter(images, s, workers=workers, device=dev))
        return time.perf_counter() - t, 0.0

    cpus = os.cpu_count() or 1
    runs = {"one-shot loop": one_shot,
            f"sequential, {WORKERS} workers": lambda: sequential(WORKERS),
            f"roundtrip, {WORKERS} workers": lambda: roundtrip(WORKERS),
            f"sequential, {cpus} workers": lambda: sequential(cpus),
            f"roundtrip, {cpus} workers": lambda: roundtrip(cpus)}
    got: dict = {k: [] for k in runs}
    for turn in range(STREAM_RUNS + 1):
        for k, fn in runs.items():
            r_ = fn()
            if turn:
                got[k].append(r_)
    rates = {}
    for k, v in got.items():
        total = statistics.median(a + b for a, b in v)
        rates[k] = n * mp / total
        split = "" if k.startswith("roundtrip") else (
            f" (encode {statistics.median(a for a, _ in v) * 1e3 / n:.2f}, decode "
            f"{statistics.median(b for _, b in v) * 1e3 / n:.2f} ms an image)")
        log(f"executor stream {k}: {n * mp / total:.2f} MP/s, {total * 1e3:.1f} ms for {n} "
            f"images{split}, median of {STREAM_RUNS} turns, each "
            f"{[round((a + b) * 1e3, 1) for a, b in v]} ms [{card}]")

    # single-image latency: through the executor, and one-shot
    lat: dict = {"executor encode": [], "executor decode": [], "one-shot encode": [],
                 "one-shot decode": []}
    img, blob = images[0], want[0][0]
    for _ in range(LATENCY_RUNS + 1):
        for k, fn in (("executor encode", lambda: enc.encode_batch([img])),
                      ("executor decode", lambda: list(dec.decode_iter([blob]))),
                      ("one-shot encode", lambda: P.encode(img, s, device=dev)),
                      ("one-shot decode", lambda: P.decode(blob, device=dev))):
            t = time.perf_counter()
            fn()
            lat[k].append((time.perf_counter() - t) * 1e3)
    for k, v in lat.items():
        v = sorted(v[1:])
        p50, p95 = statistics.median(v), v[-(-95 * len(v) // 100) - 1]  # nearest rank
        log(f"executor latency {k}, one image: p50 {p50:.2f} ms, p95 {p95:.2f} ms "
            f"({LATENCY_RUNS} calls after a warm-up) [{card}]")
    log(f"executor: every check passed in {time.perf_counter() - t0:.1f} s")
    return rates


# ---------------------------------------------------------------- rate control (K8)

#: the rate search's kernels: (source, the XLA program of ako_tpu it replaces)
RATE_KERNELS = {
    "rate_serialize": ("ako_tpu_torch/csrc/rate.cu", "ako_tpu/tools/rate.py:82"),
    "rate_sizes": ("ako_tpu_torch/csrc/rate.cu", "ako_tpu/tools/rate.py:101"),
}
#: integer operations a value that the function needs, counted from its
#: plain version (ops/rate_device.serialize_plain, then
#: kagari_device.tokenize) walked a value at a time, whatever kernel
#: computes it: K8s the quantize/gate (the segment step, the gate's two
#: compares, the multiply-high and its sign: 8); K8p the same, then the
#: neighbour compare (1), the run counter (2) and its flush wrap (2), the
#: literal's test (2), zigzag + 1 (4), the literal's gamma length (2) and
#: the masked add of its bits (2): 15 more
K8S_OPS = 8
K8P_OPS = 23
#: SASS instructions a value of the kernels' own routes, a diagnostic
#: printed beside the bound, never the bound: `python3 chip_probe.py k8`
#: from its probe loops (csrc/rate.cu's route code in a loop, over the
#: values one pass maps; NVIDIA H100 80GB HBM3): K8s's 16-byte route (115
#: a pass of 8); K8p's stage of a thread whose warp skips the tokenizer
#: (328 a pass of 16), and what the tokenizer adds where its warp holds a
#: mismatch (346 more)
K8S_SASS = 14.38
K8P_SASS = 20.5
K8P_SASS_TOKENIZE = 21.62
#: the probes' quantization factors of phase_rate_kernels, the descent's
#: x4 steps past 2^15 among them (their q/g saturate in level_qg)
RATE_QS = (0, 1, 4, 16, 64, 16384, 65536)
#: (name, settings, ratio) of phase_rate: the north star at 128-px tiles
#: and on the whole tile
RATE_CASES = [("t128_r4", dict(tiles_dimension=128), 4),
              ("t128_r12", dict(tiles_dimension=128), 12),
              ("t128_r4_g16", dict(tiles_dimension=128, gate=16), 4),
              ("t128_r12_g16", dict(tiles_dimension=128, gate=16), 12), ("whole_r12", {}, 12)]
#: the rate case whose launches and probe give the K8 rows of the JSON line
RATE_ROW = "t128_r12"
SEARCH_RUNS = 5  # timed searches per rate case, after a warm-up


def _rate_check(name, raw, schedule, ch, qs, gs) -> dict:
    """K8s and K8p against their plain versions on one raw group at one
    probe: {kernel: largest absolute difference}, raising unless both are
    equal."""
    from ako_tpu_torch.ops import rate_device as rd

    got = rd.rate_serialize(raw, schedule, ch, qs, gs)
    ref = rd.serialize_plain(raw, schedule, ch, qs, gs)
    sizes = rd.rate_sizes(raw, schedule, ch, qs, gs)
    ref_sizes = rd.probe_sizes_plain(raw, schedule, ch, qs, gs)
    err = {"rate_serialize": _max_err(got, ref), "rate_sizes": _max_err(sizes, ref_sizes)}
    if not torch.equal(got, ref) or not torch.equal(sizes, ref_sizes):
        raise AssertionError(f"K8 != plain on {name} {tuple(raw.shape)} q {qs.tolist()} "
                             f"g {gs.tolist()}: {err}")
    return err


def phase_rate_kernels(P, dev, img) -> dict:
    """K8s (rate_serialize) and K8p (rate_sizes) against serialize_plain
    and probe_sizes_plain on the card, bit for bit: the raw pyramids the
    rate search caches (tools/rate.py _CachedEncoder) of the north star at
    128-px tiles and on the whole tile (one 5,242,932-value row, 1281 K3
    chunks), of a ragged image (two shape groups), and of 512x512 crops
    with 1-4 channels, at every q of RATE_QS, gate 0 and 16, chroma_loss
    0, 1 and 3; and random full-range raw streams (-32768 among them).
    Returns each kernel's largest absolute difference (0)."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import tile_qg
    from ako_tpu_torch.ops.rate_device import probe_qg
    from ako_tpu_torch.tools.rate import _CachedEncoder

    h = img.shape[0]
    images = [("north_t128", img, 128), ("whole", img, 0), ("ragged_t128", img[: h - 10], 128)]
    images += [(f"{c}ch_512_t128", np.ascontiguousarray(img[:512, :512, :c]), 128)
               for c in (1, 2, 3, 4)]
    err = dict.fromkeys(RATE_KERNELS, 0)
    probes = values = 0
    for name, im, t in images:
        ch = im.shape[2]
        groups = set()
        for gate, chroma in itertools.product((0, 16), (0, 1, 3)):
            enc = _CachedEncoder(im, P.Settings(tiles_dimension=t, gate=gate, chroma_loss=chroma),
                                 dev)
            for q in RATE_QS:
                s = enc._settings_at(q)
                for tiles, raw in enc._tile_pyramids(s):
                    tw, th = tiles[0].w, tiles[0].h
                    qs, gs = probe_qg(tile_qg(tw, th, ch, q, gate, chroma), ch)
                    e = _rate_check(f"{name} gate {gate} chroma {chroma}", raw,
                                    geometry.lift_schedule(tw, th), ch, qs, gs)
                    err = {k: max(err[k], e[k]) for k in err}
                    groups.add((tw, th, raw.shape[0]))
                    probes += 1
                    values += raw.numel()
        log(f"  K8 {name}: shape groups {sorted(groups)}, equal at every q, gate and chroma_loss")
    rng = np.random.default_rng(8)
    schedule = geometry.lift_schedule(128, 128)
    raw = _rand16(rng, (3, schedule.coeff_count(4)), dev)
    for q in RATE_QS:
        qs, gs = probe_qg(tile_qg(128, 128, 4, q, 16, 3), 4)
        e = _rate_check("random streams", raw, schedule, 4, qs, gs)
        err = {k: max(err[k], e[k]) for k in err}
    edge = k8_edge_cases(dev)
    for name, raw, schedule, ch, qs, gs in edge:
        e = _rate_check(name, raw, schedule, ch, qs, gs)
        err = {k: max(err[k], e[k]) for k in err}
    torch.cuda.synchronize()
    log(f"kernels: K8s and K8p equal to plain on {probes} probes of {values} values, random "
        f"streams and {len(edge)} streams built for the span cut ({[n for n, *_ in edge]})")
    return err


def k8_edge_cases(dev) -> list:
    """[(name, raw (rows, n) int16 on dev, schedule, channels, qs, gs)]:
    streams built to stress K8p's and K8s's span cut on this card's grid
    (rate_device.span_cut at kernels.rate_sizes_ctas()). At q = 1, g = 0
    the values stay as they are and each head is 1, so runs of 1 cross
    segments: one row of 262,913 values (n not a multiple of 8) with runs
    of 2 x 65534 + 1 (its first flush on a span edge) and 65534 - 1 (ending
    just before one); three rows (every row but the first off 16 bytes): a
    row of one value, a run of 65534 + 1 from a span edge, runs over many
    spans with no mismatch; 80 and 81 rows of the north star's 65,560
    values in runs of 1-300; 200 rows of 25 values, shorter than one stage;
    72 more rows than the grid has CTAs, so that some CTAs take two spans;
    -32768 among the others. The long rows at q 1, the 80 and 81 rows at
    q 1 and at q 16 with gate 16, the short rows at q 16 with gate 16."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import tile_qg
    from ako_tpu_torch.ops import rate_device as rd
    from ako_tpu_torch.ops.rate_device import probe_qg
    from ako_tpu_torch.runtime import kernels

    rng = np.random.default_rng(31)
    ctas = kernels.rate_sizes_ctas()
    k = 65534
    big = geometry.lift_schedule(509, 513)
    n = big.coeff_count(1)
    ones = (np.ones((len(big.levels), 1), np.int16), np.zeros((len(big.levels), 1), np.int16))

    def noise(rows, n):
        x = rng.integers(-3, 4, (rows, n))
        x[rng.random((rows, n)) < 0.01] = -32768
        return x

    def edges(rows, row):
        cut = rd.span_cut(rows, n, ctas)
        return [rd.span_bounds(row, i, n, cut)[0] for i in range(1, cut[0])]

    one = noise(1, n)
    e = edges(1, 0)
    m = next(b for b in e if b >= k + 50) - k  # the run's first flush on an edge
    one[0, m : m + 2 * k + 1] = 1
    end = next(b for b in e if b >= m + 2 * k + 1 + 100 + k - 1)
    one[0, end - k + 1 : end] = 1  # 65533 values, ending just before an edge
    three = noise(3, n)
    three[0] = 1
    e = edges(3, 1)
    start = next(b for b in e if b >= 1000)
    three[1, start : start + k + 1] = 1
    three[2, 100 : 100 + 3 * k] = 1
    out = [("k8 flush on a span edge, 1 row", one, big, 1, *ones),
           ("k8 one value and spans with no mismatch, 3 rows", three, big, 1, *ones)]
    north = geometry.lift_schedule(128, 128)
    nn = north.coeff_count(4)
    for rows in (80, 81):
        runs = np.repeat(rng.integers(-3, 3, rows * nn // 40), rng.integers(1, 300, rows * nn // 40))
        x = runs[: rows * nn].reshape(rows, nn)
        x[:, ::997] = -32768
        out.append((f"k8 runs of 1-300, {rows} rows", x, north, 4,
                    *probe_qg(tile_qg(128, 128, 4, 16, 16, 3), 4)))
        out.append((f"k8 runs of 1-300, {rows} rows, q 1", x, north, 4,
                    np.ones((len(north.levels), 4), np.int16),
                    np.zeros((len(north.levels), 4), np.int16)))
    tiny = geometry.lift_schedule(4, 5)
    for rows in (200, ctas + 72):  # the second: more rows than CTAs, some take two spans
        x = noise(rows, tiny.coeff_count(1))
        x[::3] = 2
        out.append((f"k8 {rows} rows of {tiny.coeff_count(1)} values", x, tiny, 1,
                    *probe_qg(tile_qg(4, 5, 1, 16, 16, 0), 1)))
    return [(name, torch.from_numpy(x.astype(np.int16)).to(dev), sch, ch, qs, gs)
            for name, x, sch, ch, qs, gs in out]


@contextlib.contextmanager
def recorded_probes():
    """[(q, size)] of every _CachedEncoder.size_at call inside the block."""
    from ako_tpu_torch.tools import rate

    probes = []
    size_at = rate._CachedEncoder.size_at

    def recorded(self, q):
        n = size_at(self, q)
        probes.append((q, n))
        return n

    rate._CachedEncoder.size_at = recorded
    try:
        yield probes
    finally:
        rate._CachedEncoder.size_at = size_at


def rate_expected_launches(img, s, probes) -> dict:
    """Launches of one encode_with_ratio search: the lift once per colour
    variant and shape group (lift_level before pyramid_start, then
    lift_pyramid), one K8p per probe and shape group, and at the end one
    K8s and one K3 per shape group; nothing else."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import checked_settings

    h, w, _ = img.shape
    groups = len(geometry.group_by_shape(geometry.tile_grid(w, h, s.tiles_dimension)))
    variants = len({checked_settings(s.replace(quantization=q)).color for q, _ in probes})
    lifts = expected_launches(img, {"rate": s}, False, "fused")
    out = dict.fromkeys(lifts, 0)
    out.update(lift_level=variants * lifts["lift_level"],
               lift_pyramid=variants * lifts["lift_pyramid"], rate_sizes=len(probes) * groups,
               rate_serialize=groups, kagari_encode=groups)
    return out


def phase_rate(P, dev, img, card) -> dict:
    """tools/rate.encode_with_ratio on the north star (RATE_CASES), each
    search with the launch counts reset just before and read just after:
    every probe's size equal to the length of the native codec's blob at
    its q (runtime/hostcodec.py), the emitted blob byte-equal to the native
    codec's and to the port's encode at the emitted q, and the launches
    exact (rate_expected_launches: no lift launch per probe). Prints each
    probe trajectory, the search's wall ms (median of 5 after a warm-up)
    against the sum of one-shot encode ms at the same q's, one warm
    search's device busy share (profiler), and K8p's and K8s's device ms
    on the cached pyramid at one probe (profiler; plain versions by CUDA
    events). Returns {"blobs": {case: blob}, "launches": RATE_ROW's counts,
    "ms": {kernel: (device ms, plain ms)}, "raw": RATE_ROW's raw shape}."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import tile_qg
    from ako_tpu_torch.ops import rate_device as rd
    from ako_tpu_torch.tools.rate import _CachedEncoder, encode_with_ratio

    blobs, row_launches = {}, None
    for name, kw, ratio in RATE_CASES:
        s = P.Settings(**kw)
        reset_launches()
        with recorded_probes() as probes:
            blob, q = encode_with_ratio(img, s, ratio, device=dev)
        launches = all_launches()
        sizes = dict(probes)
        emit = probes[-1][0] if probes[-1][1] == sizes[q] else q
        for pq, size in probes:
            native = len(oracle_encode(img, s.replace(quantization=pq)))
            if size != native:
                raise AssertionError(f"rate {name}: size_at({pq}) = {size}, native codec {native}")
        if blob != oracle_encode(img, s.replace(quantization=emit)):
            raise AssertionError(f"rate {name}: blob differs from the native codec's at q {emit}")
        if blob != P.encode(img, s.replace(quantization=emit), device=dev):
            raise AssertionError(f"rate {name}: blob differs from the port's encode at q {emit}")
        want = rate_expected_launches(img, s, probes)
        if launches != want:
            raise AssertionError(f"rate {name}: launch counts {launches}, expected {want}")
        blobs[name] = blob
        if name == RATE_ROW:
            row_launches = launches
        log(f"rate {name}: ratio {ratio}, probes (q, bytes) {probes}, chosen q {q}, emitted at q "
            f"{emit}: {len(blob)} B, every size and the blob equal to the native codec's; "
            f"launches { {k: v for k, v in launches.items() if v} } (expected)")

        search = _median_ms(lambda: encode_with_ratio(img, s, ratio, device=dev), SEARCH_RUNS)
        one_shot = sum(_median_ms(lambda: P.encode(img, s.replace(quantization=pq), device=dev))
                       for pq, _ in probes)
        r = _profile_until(lambda: encode_with_ratio(img, s, ratio, device=dev))
        per = {k: round(v, 4) for k, v in sorted(r["per"].items())}
        log(f"  rate {name}: search {search:.2f} ms (median of {SEARCH_RUNS}), one-shot encode "
            f"at its {len(probes)} q's {one_shot:.2f} ms in all; one warm search: wall "
            f"{r['wall']:.3f} ms, "
            f"device busy {r['busy']:.4f} ms (idle {100 * (1 - r['busy'] / r['wall']):.1f}%), "
            f"device ms {per} [{card}]")

    # K8p and K8s alone on the cached pyramid at one probe (q 16)
    ms = {}
    for name, t in (("north_t128", 128), ("whole", 0)):
        s = P.Settings(tiles_dimension=t)
        enc = _CachedEncoder(img, s, dev)
        ((tiles, raw),) = enc._tile_pyramids(enc._settings_at(16))
        tw, th, ch = tiles[0].w, tiles[0].h, img.shape[2]
        schedule = geometry.lift_schedule(tw, th)
        qs, gs = rd.probe_qg(tile_qg(tw, th, ch, 16, 0, 1), ch)
        line = []
        for k, fn, plain in (
                ("rate_sizes", lambda: rd.rate_sizes(raw, schedule, ch, qs, gs),
                 lambda: rd.probe_sizes_plain(raw, schedule, ch, qs, gs)),
                ("rate_serialize", lambda: rd.rate_serialize(raw, schedule, ch, qs, gs),
                 lambda: rd.serialize_plain(raw, schedule, ch, qs, gs))):
            kern, events = _launch_ms(fn, k), _event_ms(fn)
            plain_ms = _event_ms(plain, iters=3)
            line.append(f"{k} {kern:.4f} ms (profiler, median of 20), {events:.4f} ms "
                        f"(CUDA events), plain {plain_ms:.4f} ms")
            if kern != kern:  # no device time in the profile: CUDA events
                kern = events
            if name == "north_t128":
                ms[k] = (round(kern, 4), round(plain_ms, 4))
        bound = rate_bounds_ms(tuple(raw.shape))
        sass = k8_sass_per_value(rd.serialize_plain(raw, schedule, ch, qs, gs))
        log(f"  K8 alone on the {name} raw pyramid {tuple(raw.shape)} at q 16: " + "; ".join(line)
            + f"; bounds {bound} ({int_ops_per_s():.4g} integer operations a second); the "
            f"kernels' own SASS instructions a value (diagnostic): {sass} [{card}]")
        if name == "north_t128":
            ms["bound"] = bound
    return {"blobs": blobs, "launches": row_launches, "ms": ms}


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def phase_cli(P, dev, img, rate_blob) -> None:
    """The CLIs on the card, each `python -m` in a process of its own:
    the north star written as a PNG by the port's pngout; akoenc -t 128
    -q 16 byte-equal to the native codec; akoenc -t 128 -dev-r 12 equal to
    phase_rate's blob; akodec to a PNG whose pixels equal the native
    decode's; a truncated .ako exits 1 with an akodec: message."""
    import tempfile

    from PIL import Image

    from ako_tpu_torch.tools.pngout import write_png

    # a child of this script with TEARDOWN_CUPTI set would hang in its exit
    env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}

    def run(tool, *args):
        res = subprocess.run([sys.executable, "-m", f"ako_tpu_torch.tools.{tool}", *args],
                             capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
        return res.returncode, res.stdout, res.stderr

    with tempfile.TemporaryDirectory() as tmp:
        png, ako, rate_ako, out_png, cut = (os.path.join(tmp, f) for f in (
            "north.png", "north.ako", "rate.ako", "decoded.png", "cut.ako"))
        write_png(png, img)
        t = time.perf_counter()
        rc, out, err = run("akoenc", "-i", png, "-o", ako, "-t", "128", "-q", "16")
        blob = _read(ako) if rc == 0 else b""
        if rc != 0 or blob != oracle_encode(img, P.Settings(quantization=16, tiles_dimension=128)):
            raise AssertionError(f"akoenc -q 16: exit {rc}, blob differs from the native codec's\n"
                                 f"{out}{err}")
        log(f"cli: akoenc -t 128 -q 16: {out.strip()} (byte-equal to the native codec)")
        rc, out, err = run("akoenc", "-i", png, "-o", rate_ako, "-t", "128", "-dev-r", "12")
        if rc != 0 or _read(rate_ako) != rate_blob:
            raise AssertionError(f"akoenc -dev-r 12: exit {rc}, blob differs from phase_rate's\n"
                                 f"{out}{err}")
        log(f"cli: akoenc -t 128 -dev-r 12: {' | '.join(out.strip().splitlines())} (equal to the "
            "search's blob)")
        rc, out, err = run("akodec", "-i", ako, "-o", out_png)
        pix = np.asarray(Image.open(out_png)) if rc == 0 else None
        if rc != 0 or not np.array_equal(pix, oracle_decode(blob)):
            raise AssertionError(f"akodec: exit {rc}, pixels differ from the native decode's\n"
                                 f"{out}{err}")
        log(f"cli: akodec: {out.strip()} (pixels equal to the native decode's)")
        with open(cut, "wb") as f:
            f.write(blob[: len(blob) // 2])
        rc, out, err = run("akodec", "-i", cut, "-o", out_png)
        if rc != 1 or not err.startswith("akodec: "):
            raise AssertionError(f"akodec on a truncated blob: exit {rc}, stderr {err!r}")
        log(f"cli: akodec on a truncated blob: exit 1, {err.strip()!r}; four processes in "
            f"{time.perf_counter() - t:.1f} s")


def k8_sass_per_value(values) -> dict:
    """The K8 kernels' own SASS instructions a value on (rows, n) probe
    streams, a diagnostic: K8S_SASS; K8P_SASS, and K8P_SASS_TOKENIZE more
    for the values whose 512-value group (a warp's part of a stage,
    counted from each row's start) holds a mismatch, which K8p's
    tokenizer codes."""
    rows, n = values.shape
    mm = torch.ones((rows, -(-n // 512) * 512), dtype=torch.bool, device=values.device)
    mm[:, 1:n] = values[:, 1:] != values[:, :-1]
    mm[:, n:] = False
    hit = mm.view(rows, -1, 512).any(dim=-1)
    size = torch.full((hit.shape[1],), 512, device=values.device)
    size[-1] = n - 512 * (hit.shape[1] - 1)
    tokenized = int((hit * size).sum())
    return {"rate_sizes": round(K8P_SASS + K8P_SASS_TOKENIZE * tokenized / (rows * n), 2),
            "rate_serialize": K8S_SASS}


def rate_bounds_ms(raw_shape) -> dict:
    """Least time of K8p and K8s at one probe on a (T, n) raw pyramid:
    {kernel: (ms, "bytes" or "operations")}, the larger of the bytes over
    the card's memory rate (K8p: the raw streams read once and one int64 a
    row; K8s: the raw streams read once and the streams written once) and
    the function's operations (K8P_OPS, K8S_OPS a value) over the 32-bit
    integer rate."""
    rows, n = raw_shape
    b = {"rate_sizes": 2 * rows * n + 8 * rows, "rate_serialize": 4 * rows * n}
    ops = {"rate_sizes": rows * n * K8P_OPS, "rate_serialize": rows * n * K8S_OPS}
    out = {}
    for k in b:
        by_bytes, by_ops = b[k] / HBM_BYTES_PER_S * 1e3, ops[k] / int_ops_per_s() * 1e3
        out[k] = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    return out


# ---------------------------------------------------------------- parallel

#: K7: the shard-table instances of csrc/lift_level.cu (parallel/halo.py)
K7 = {
    "lift_level_shards": "ako_tpu/parallel/halo.py:349",
    "unlift_level_shards": "ako_tpu/parallel/halo.py:436",
}
K7_SOURCE = "ako_tpu_torch/csrc/lift_level.cu"
#: (w, h, channels, shards) of the parallel_kernels phase: the whole
#: north-star tile's levels over 8 and 3 shards (every level ragged over
#: 3), the tractor size over 8 (ragged from level 2, odd sides at level
#: 5), odd sides, and T = 25 pairs over 8 (a one-pair and an empty shard)
K7_SHAPES = [(1024, 1280, 4, 8), (1024, 1280, 4, 3), (1632, 2464, 4, 8), (127, 127, 3, 8),
             (96, 100, 3, 8), (40, 50, 2, 8)]
TRACTOR = dict(seed=43, h=2464, w=1632, ch=4)  # tests/test_parallel.py:145's size
K7_POISON = 2  # poisoned pairs on each side of a K7 window buffer or segment
MULTIHOST_IMAGES = 4  # images of the two-process HostShardedPipeline check


def _poison_rows(t, dim: int, poison: int, gen):
    """t inside a buffer with `poison` random rows (along dim) on each
    side of it."""
    shape = list(t.shape)
    shape[dim] += 2 * poison
    buf = torch.randint(-32768, 32768, shape, dtype=torch.int16, device=t.device, generator=gen)
    buf.narrow(dim, poison, t.shape[dim]).copy_(t)
    return buf


def k7_windows(plane, ll_plane, chunk, schedule, k, pairs, wavelet, wrap, gen):
    """The K7 inputs of one shard's pairs at level k, from the level's
    (C, h, w) plane, its (C, T, tw) LL and its (C, 1 + 3 T tw) chunk,
    each window inside K7_POISON poisoned pairs on each side: the
    forward's window, and the inverse's LL and chunk windows; with their
    first pair."""
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.ops.wavelets import effective_wavelet
    from ako_tpu_torch.parallel import halo

    lvl = schedule.levels[k]
    T, tw, C = lvl.target_h, lvl.target_w, plane.shape[0]
    win_lo, win_n = lk.row_window(T, pairs, effective_wavelet(wavelet, tw, T), wrap)
    dev = plane.device
    rows = torch.tensor(halo.window_rows(win_lo, win_n, lvl, wrap), device=dev)
    win = _poison_rows(plane[:, rows], 1, 2 * K7_POISON, gen)
    pr = torch.tensor(halo.window_pairs(win_lo, win_n, T, wrap), device=dev)
    llw = _poison_rows(ll_plane[:, pr], 1, K7_POISON, gen)
    cbd = _poison_rows(chunk[:, 1:].view(C, 3, T, tw)[:, :, pr], 2, K7_POISON, gen)
    cw = torch.cat([chunk[:, :1], cbd.reshape(C, -1)], dim=1).reshape(-1)
    return win, llw, cw, win_lo - K7_POISON


def k7_segments(x, gen, parts: int = 3):
    """x's rows (along -2) cut at random into at most `parts` runs, each a
    Segment in a buffer of its own: K7_POISON random rows before and after
    it, and every other buffer one element off 16-byte alignment (its rows
    loaded one sample at a time)."""
    from ako_tpu_torch.ops import lift_kernels as lk

    n = x.shape[-2]
    cuts = torch.randint(1, max(n, 2), (parts - 1,), generator=gen, device=x.device).tolist()
    bounds = sorted({0, n, *cuts})
    segs = []
    for i, (a, b) in enumerate(zip(bounds, bounds[1:])):
        shape = (*x.shape[:-2], b - a + 2 * K7_POISON, x.shape[-1])
        flat = torch.randint(-32768, 32768, (math.prod(shape) + 1,), dtype=torch.int16,
                             device=x.device, generator=gen)
        buf = flat[i % 2 : i % 2 + math.prod(shape)].view(shape)
        seg = buf.narrow(-2, K7_POISON, b - a)
        seg.copy_(x[..., a:b, :])
        segs.append(lk.Segment(a, seg))
    return segs


def phase_parallel_kernels(dev) -> dict:
    """K7 (lift_level_shards / unlift_level_shards) against its plain
    versions on the card, bit for bit: every wavelet x wrap on each of
    K7_SHAPES, every sharded level (plan_levels) of random int16 planes and
    random streams whose q heads wrap. Launches of every non-empty shard
    at once (one card's) and of alternate shards (two cards'), the sources
    cut into segments in buffers of their own, poisoned outside them (K7
    must read none of those rows; the plain version assembles each
    window by indexing), some of them not 16-byte aligned, REPEAT's first
    and last shards reading the far end's segment, the outputs poisoned
    before and compared whole (no store outside the launch's pairs); and
    every shard alone on its window buffer (lift_level_rows /
    unlift_level_rows, poisoned outside it), an empty shard refused with
    no launch. Returns the largest absolute difference per kernel (must be
    0)."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.core.settings import Wavelet, Wrap
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.ops.quantization import level_qg
    from ako_tpu_torch.parallel import halo

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    err = dict.fromkeys(K7, 0)
    alone = tables = refused = 0
    combos = list(itertools.product([Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR], list(Wrap)))
    heads = torch.tensor([0, 1, 7, 300, -5], dtype=torch.int16, device=dev)
    rand = lambda *shape: torch.randint(-32768, 32768, shape, dtype=torch.int16, device=dev,
                                        generator=gen)

    def check(name, got, ref, what):
        e = max(_max_err(a, b) for a, b in zip(got, ref))
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name} != plain for {what}: {e}")

    for w, h, ch, n in K7_SHAPES:
        schedule = geometry.lift_schedule(w, h)
        for i, (wavelet, wrap) in enumerate(combos):
            qg = level_qg(schedule, ch, (0, 1, 16)[i % 3], 3, 2)
            for k in range(sum(halo.plan_levels(schedule, n, wavelet, wrap))):
                lvl = schedule.levels[k]
                T, tw = lvl.target_h, lvl.target_w
                plane, ll_plane = rand(ch, lvl.current_h, lvl.current_w), rand(ch, T, tw)
                chunk = rand(ch, 1 + 3 * T * tw)
                chunk[:, 0] = heads[torch.randint(0, 5, (ch,), device=dev, generator=gen)]
                what = f"{w}x{h}x{ch} over {n}, level {k}, {wavelet.name} {wrap.name}"
                # launches of several shards, the sources cut into segments
                segs, ll_segs = k7_segments(plane, gen), k7_segments(ll_plane, gen)
                cbd_segs = k7_segments(chunk[:, 1:].view(ch, 3, T, tw), gen)
                pairs = [p for p in halo.shard_pairs(T, n) if p[0] < p[1]]
                for shards in (pairs, pairs[0::2], pairs[1::2]):
                    outs = [rand(ch, T, tw), rand(ch * (1 + 3 * T * tw))]
                    ref = [t.clone() for t in outs]
                    lk.lift_level_shards(segs, schedule, k, shards, *outs, 0, wavelet, wrap, qg)
                    lk.lift_level_shards_plain(segs, schedule, k, shards, *ref, 0, wavelet, wrap,
                                               qg)
                    check("lift_level_shards", outs, ref, f"{what}, shards {shards}")
                    out = rand(ch, lvl.current_h, lvl.current_w)
                    ref = out.clone()
                    args = (ll_segs, cbd_segs, chunk[:, 0], schedule, k, shards)
                    lk.unlift_level_shards(*args, out, 0, wavelet, wrap)
                    lk.unlift_level_shards_plain(*args, ref, 0, wavelet, wrap)
                    check("unlift_level_shards", [out], [ref], f"{what}, shards {shards}")
                    tables += 1
                # each shard alone on its window buffer
                for pairs in halo.shard_pairs(T, n):
                    if pairs[0] == pairs[1]:
                        before = lk.LAUNCHES["lift_level_shards"]
                        try:
                            lk.lift_level_rows(plane, schedule, k, pairs, 0, wavelet, wrap, qg)
                        except ValueError:
                            refused += lk.LAUNCHES["lift_level_shards"] == before
                            continue
                        raise AssertionError(f"K7 took an empty shard {pairs} of {T} pairs")
                    win, llw, cw, lo = k7_windows(plane, ll_plane, chunk, schedule, k, pairs,
                                                  wavelet, wrap, gen)
                    fwd = (schedule, k, pairs, lo, wavelet, wrap)
                    check("lift_level_shards", lk.lift_level_rows(win, *fwd, qg),
                          lk.lift_level_rows_plain(win, *fwd, qg), f"{what}, alone {pairs}")
                    check("unlift_level_shards", [lk.unlift_level_rows(llw, cw, *fwd)],
                          [lk.unlift_level_rows_plain(llw, cw, *fwd)], f"{what}, alone {pairs}")
                    alone += 1
    torch.cuda.synchronize()
    if not refused:
        raise AssertionError("parallel_kernels: no empty shard was tried")
    log(f"parallel_kernels: lift_level_shards/unlift_level_shards equal to plain on {tables} "
        f"launches of several shards each way (every shard at once and alternate shards, sources "
        f"in segments poisoned outside them) and {alone} one-shard launches on window buffers "
        f"({len(K7_SHAPES)} shapes x 3 wavelets x 4 wraps, every sharded level); {refused} empty "
        f"shards refused with no launch")
    return err


def _planes(img, s):
    """The tile's int16 planes after the colour transform, on the card."""
    from ako_tpu_torch.encode import checked_settings
    from ako_tpu_torch.ops.colorspace import to_planar_yuv

    s = checked_settings(s)
    x = torch.from_numpy(np.ascontiguousarray(img)).cuda()
    return to_planar_yuv(x, s.color, bool(s.discard_non_visible)).contiguous()


def k7_launches(schedule, n, wavelet, wrap, devices: int) -> int:
    """K7 launches of one sharded forward (or inverse) over n shards whose
    devices alternate among `devices`: one a sharded level and device with
    a non-empty shard."""
    from ako_tpu_torch.parallel import halo

    plan = halo.plan_levels(schedule, n, wavelet, wrap)
    return sum(len({i % devices for i, (p0, p1) in
                    enumerate(halo.shard_pairs(schedule.levels[k].target_h, n)) if p0 < p1})
               for k in range(sum(plan)))


def k7_halo_copies(schedule, n, wavelet, wrap) -> tuple:
    """halo.COPIES of one sharded forward and of one inverse over n shards
    whose devices alternate between two (home the even shards'), from the
    plan: window copies, one per run of rows that a device's windows need
    and the other device holds within one shard's rows (the input planes
    and the stream are home's), and one a level for the other device's q
    heads; gathers, one per shard of the other device a level and its last
    level's LL (forward), its level-0 rows (inverse)."""
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.ops.wavelets import effective_wavelet
    from ako_tpu_torch.parallel import halo

    def runs(rows, part):
        rows = sorted(rows)
        return sum(1 for i, r in enumerate(rows)
                   if i == 0 or rows[i - 1] != r - 1 or part(rows[i - 1]) != part(r))

    ks = sum(halo.plan_levels(schedule, n, wavelet, wrap))
    m = [-(-lvl.target_h // n) for lvl in schedule.levels]
    shards = lambda k, d: [p for i, p in enumerate(halo.shard_pairs(schedule.levels[k].target_h, n))
                           if i % 2 == d and p[0] < p[1]]
    fwd = {"window": 0, "gather": len(shards(ks - 1, 1))}
    inv = {"window": 0, "gather": len(shards(0, 1))}
    for k in range(ks):
        lvl = schedule.levels[k]
        weff = effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
        fwd["gather"] += len(shards(k, 1))
        for d in (0, 1):
            wins = [lk.row_window(lvl.target_h, pr, weff, wrap) for pr in shards(k, d)]
            # forward: the plane's rows, held as the level before's LL pairs
            part = (lambda r: 0) if k == 0 else (lambda r: r // m[k - 1])
            rows = {r for lo, wn in wins for r in halo.window_rows(lo, wn, lvl, wrap)}
            fwd["window"] += runs([r for r in rows if part(r) % 2 != d], part)
            # inverse: the LL pairs, held as the rows of the plane above
            part = (lambda p: 0) if k + 1 == ks else (lambda p: (p // 2) // m[k + 1])
            pairs = {p for lo, wn in wins for p in halo.window_pairs(lo, wn, lvl.target_h, wrap)}
            inv["window"] += runs([p for p in pairs if part(p) % 2 != d], part)
            if d == 1 and wins:
                inv["window"] += runs(pairs, lambda p: 0) + 1  # the C, B, D rows, the q heads
    return fwd, inv


def multihost_worker(coord: str, nproc: str, pid: str, outfile: str) -> int:
    """One process of the two-process HostShardedPipeline check: joins the
    gloo group, runs its round-robin shard of MULTIHOST_IMAGES north-star
    images through the executor on the card, and pickles its blobs, its
    decoded images and the process-wide mesh's shape."""
    import pickle

    import ako_tpu_torch as P
    from ako_tpu_torch.parallel import multihost
    from ako_tpu_torch.utils.corpus import corpus

    multihost.initialize(coord, int(nproc), int(pid))
    mesh = multihost.global_mesh()
    images = corpus(NORTH_STAR["seed"], MULTIHOST_IMAGES, NORTH_STAR["h"], NORTH_STAR["w"],
                    NORTH_STAR["ch"])
    s = north_star_settings(P)["north_t128"]
    pipe = multihost.HostShardedPipeline(s, workers=4, device="cuda:0")
    blobs = dict(pipe.encode_shard(images))
    own = [blobs.get(i) for i in range(len(images))]
    pixels = dict(pipe.decode_shard(own))
    with open(outfile, "wb") as f:
        pickle.dump({"blobs": blobs, "pixels": pixels, "mesh_shape": mesh.shape,
                     "process": multihost.process_info()}, f)
    return 0


def _multihost_check(P, card) -> None:
    """HostShardedPipeline in two processes sharing the card over gloo: each
    process's blobs by global index equal a one-process encode and the
    native oracle, its images the native decode, and the union of the
    shards covers the stream exactly once."""
    import pickle
    import socket

    from ako_tpu_torch.utils.corpus import corpus

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{sock.getsockname()[1]}"
    out_dir = os.path.join(ROOT, "ako_tpu_torch", "_build")
    os.makedirs(out_dir, exist_ok=True)
    outs = [os.path.join(out_dir, f"multihost{pid}.pkl") for pid in range(2)]
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multihost-worker",
                               coord, "2", str(pid), outs[pid]], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text in zip(procs, logs):
        if p.returncode != 0:
            raise AssertionError(f"multihost worker failed ({p.returncode}):\n{text[-3000:]}")
    wall = time.perf_counter() - t
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
        os.remove(path)
    images = corpus(NORTH_STAR["seed"], MULTIHOST_IMAGES, NORTH_STAR["h"], NORTH_STAR["w"],
                    NORTH_STAR["ch"])
    s = north_star_settings(P)["north_t128"]
    want = [oracle_encode(img, s) for img in images]
    for pid, r in enumerate(results):
        if r["process"] != (pid, 2) or r["mesh_shape"] != {"hosts": 2,
                                                          "tiles": torch.cuda.device_count()}:
            raise AssertionError(f"multihost process {pid}: {r['process']}, {r['mesh_shape']}")
        for gidx, blob in r["blobs"].items():
            if blob != want[gidx] or blob != P.encode(images[gidx], s, device="cuda:0"):
                raise AssertionError(f"multihost: blob {gidx} differs from a one-process encode")
            if not np.array_equal(r["pixels"][gidx], oracle_decode(blob)):
                raise AssertionError(f"multihost: image {gidx} differs from the native decode")
    got = sorted(i for r in results for i in r["blobs"])
    if got != list(range(MULTIHOST_IMAGES)):
        raise AssertionError(f"multihost: the shards cover {got}")
    log(f"parallel: HostShardedPipeline in 2 processes sharing the card over gloo: {got} covered "
        f"once, blobs equal to a one-process encode and the native codec, images to the native "
        f"decode; {wall:.1f} s wall with the processes' start-up [{card}]")


def phase_parallel(P, dev, img, oracle, card) -> dict:
    """ako_tpu_torch.parallel on the card, every shard a stream of its own.
    The main path, driven with the launch counts reset just before and
    read just after: forward_tile_sharded / inverse_tile_sharded on the
    north star's whole tile (1024x1280 RGBA planes after colour) over 8
    shards of cuda:0 and over 3, under all four wraps, and on the tractor
    size over 8; K7's launches must be the plan's, one a sharded level
    and device, and no halo copy may be made (one card). The same calls
    with alternate shards counted as two devices (halo._device_key
    patched): K7's launches and halo.COPIES each call's plan's
    (k7_launches, k7_halo_copies). Then every stream, of one device and
    of two, equal to the one-device forward_tile's and the native
    codec's, every reconstruction to the one-device inverse_tile's and
    the native one;
    encode_image_sharded / decode_image_sharded (both entropy routes) on
    the north star at 128-px tiles over 8 and 3 shards against the port's
    encode and the native oracle; a step on a 2 x 4 ("tiles", "rows") mesh;
    the same on distinct cards when there are several; and
    HostShardedPipeline in two processes. Returns K7's row material:
    launches, device ms, plain ms and bound."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.core.settings import Wrap
    from ako_tpu_torch.encode import checked_settings, tile_qg
    from ako_tpu_torch.ops import lifting
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.parallel import halo, make_mesh
    from ako_tpu_torch.parallel import tiles as ptiles
    from ako_tpu_torch.runtime import hostcodec
    from ako_tpu_torch.utils.corpus import corpus

    t0 = time.perf_counter()
    s = checked_settings(P.Settings())
    tractor = corpus(TRACTOR["seed"], 1, TRACTOR["h"], TRACTOR["w"], TRACTOR["ch"])[0]
    tiles = {"north": (img, _planes(img, s)), "tractor": (tractor, _planes(tractor, s))}
    mesh8 = make_mesh((8,), ("rows",), devices=[dev] * 8)
    mesh3 = make_mesh((3,), ("rows",), devices=[dev] * 3)
    runs = [("north", mesh8, wrap) for wrap in Wrap] + [("north", mesh3, wrap) for wrap in Wrap]
    runs.append(("tractor", mesh8, s.wrap))
    for name in ("north", "tractor"):
        schedule = geometry.lift_schedule(tiles[name][0].shape[1], tiles[name][0].shape[0])
        want = 5 if name == "north" else 6
        if sum(halo.plan_levels(schedule, 8, s.wavelet, s.wrap)) < want:
            raise AssertionError(f"parallel: {name} shards fewer than {want} levels over 8")

    def args(name, wrap):
        h, w, ch = tiles[name][0].shape
        schedule = geometry.lift_schedule(w, h)
        return schedule, tile_qg(w, h, ch, s.quantization, s.gate, s.chroma_loss), ch

    # the main path
    reset_launches()
    copies = dict(halo.COPIES)
    out = []
    per_call = []
    for name, mesh, wrap in runs:
        schedule, qg, ch = args(name, wrap)
        before = dict(lk.LAUNCHES)
        stream = halo.forward_tile_sharded(tiles[name][1], schedule, s.wavelet, wrap, qg, mesh)
        out.append((stream, halo.inverse_tile_sharded(stream, schedule, s.wavelet, wrap, ch, mesh)))
        per_call.append(tuple(lk.LAUNCHES[k] - before[k] for k in K7))
    torch.cuda.synchronize()
    launches = {k: all_launches()[k] for k in K7}
    copies = {k: halo.COPIES[k] - copies[k] for k in copies}
    plan = [k7_launches(args(name, wrap)[0], mesh.size, s.wavelet, wrap, 1)
            for name, mesh, wrap in runs]
    if per_call != [(p, p) for p in plan]:
        raise AssertionError(f"parallel: K7 launches a call {per_call}, the plan gives {plan} "
                             "(one a sharded level and device) each way")
    if plan[0] != 5:
        raise AssertionError(f"parallel: the whole tile over 8 shards of one card plans {plan[0]} "
                             "K7 launches a call, not 5")
    if copies != {"window": 0, "gather": 0}:
        raise AssertionError(f"parallel: halo copies {copies} on one card, expected none")

    # the exchange between devices on this card: the same calls with the
    # shards' grouping key monkeypatched so that alternate shards count as
    # two devices (launches on the streams of shards 0 and 1, rows of the
    # other "device" copied after its events, gathers home)
    real_key = halo._device_key
    out2, plan2 = [], []
    halo_copies = {"window": 0, "gather": 0}
    for name, mesh, wrap in runs:
        schedule, qg, ch = args(name, wrap)
        side = {id(sh): i % 2 for i, sh in enumerate(mesh.shards("rows"))}
        want = k7_halo_copies(schedule, mesh.size, s.wavelet, wrap)
        before = dict(lk.LAUNCHES)
        halo._device_key = lambda sh: side[id(sh)]
        try:
            c0 = dict(halo.COPIES)
            stream = halo.forward_tile_sharded(tiles[name][1], schedule, s.wavelet, wrap, qg, mesh)
            c1 = dict(halo.COPIES)
            rec = halo.inverse_tile_sharded(stream, schedule, s.wavelet, wrap, ch, mesh)
            got = ({k: c1[k] - c0[k] for k in c0}, {k: halo.COPIES[k] - c1[k] for k in c0})
        finally:
            halo._device_key = real_key
        out2.append((stream, rec))
        two = k7_launches(schedule, mesh.size, s.wavelet, wrap, 2)
        plan2.append(two)
        per = tuple(lk.LAUNCHES[k] - before[k] for k in K7)
        if per != (two, two) or got != want:
            raise AssertionError(f"parallel: {name} over {mesh.size} {wrap.name} as two devices: K7 "
                                 f"launches {per}, the plan's {two} each way; halo copies {got}, "
                                 f"the plan's {want}")
        for c in got:
            for k in c:
                halo_copies[k] += c[k]
    torch.cuda.synchronize()
    if not all(halo_copies.values()):
        raise AssertionError(f"parallel: the two-device runs made halo copies {halo_copies}")

    for (name, mesh, wrap), (stream, rec), (stream2, rec2) in zip(runs, out, out2):
        schedule, qg, ch = args(name, wrap)
        planes = tiles[name][1]
        one = lifting.forward_tile(planes, schedule, s.wavelet, wrap, qg)
        native = hostcodec.tile_lift(planes.cpu().numpy(), s.wavelet, wrap, qg)
        if not (torch.equal(stream, one) and torch.equal(stream2, one)
                and np.array_equal(stream.cpu().numpy(), native)):
            raise AssertionError(f"parallel: {name} over {mesh.size} {wrap.name}: the sharded "
                                 "stream (one or two devices) differs from forward_tile's or the "
                                 "native codec's")
        back = lifting.inverse_tile(stream, schedule, s.wavelet, wrap, ch)
        h, w = planes.shape[1:]
        if not (torch.equal(rec, back) and torch.equal(rec2, back)
                and np.array_equal(rec.cpu().numpy(), hostcodec.tile_unlift(
                    stream.cpu().numpy(), w, h, ch, s.wavelet, wrap))):
            raise AssertionError(f"parallel: {name} over {mesh.size} {wrap.name}: the sharded "
                                 "reconstruction (one or two devices) differs from inverse_tile's "
                                 "or the native one")
    log(f"parallel: forward/inverse_tile_sharded on the whole tile over 8 and 3 shards of "
        f"cuda:0 (4 wraps each) and the tractor size over 8: streams equal to forward_tile's and "
        f"the native codec's, reconstructions to inverse_tile's and the native one; K7 "
        f"{launches} (the plan's: {plan[0]} a call each way on the whole tile over 8, one a "
        f"sharded level); halo copies {copies} (none on one card). The same {len(runs)} calls "
        f"with alternate shards counted as two devices: equal results, K7 launches the plan's "
        f"({plan2[0]} a call each way on the whole tile over 8), halo copies {halo_copies} in all, "
        f"each call's the plan's (one per run of rows held by the other device)")

    # the tile path
    st = north_star_settings(P)["north_t128"]
    want_blob, want_pix = oracle["north_t128"]
    tmesh = {n: make_mesh((n,), ("tiles",), devices=[dev] * n) for n in (8, 3)}
    for n, mesh in tmesh.items():
        blob = ptiles.encode_image_sharded(img, st, mesh)
        if blob != want_blob or blob != P.encode(img, st, device=dev):
            raise AssertionError(f"parallel: encode_image_sharded over {n}: blob differs")
        for de in (True, False):
            pix, _, _ = ptiles.decode_image_sharded(blob, mesh, device_entropy=de)
            if not np.array_equal(pix, want_pix):
                raise AssertionError(f"parallel: decode_image_sharded over {n} (device entropy "
                                     f"{de}): pixels differ")
    log("parallel: encode_image_sharded / decode_image_sharded (device entropy on and off) on "
        "the north star at 128-px tiles over 8 and 3 shards (80 tiles, padded to 81): blobs "
        "equal to the port's encode and the native codec, pixels to the native decode")

    # a step on a 2 x 4 ("tiles", "rows") mesh, as dryrun_multichip
    mesh2 = make_mesh((2, 4), ("tiles", "rows"), devices=[dev] * 8)
    small = img[:128, :128]
    got = ptiles.encode_tiles_sharded(small, checked_settings(P.Settings(tiles_dimension=32)),
                                      mesh2)
    from ako_tpu_torch.encode import encode_tiles_device

    ref = encode_tiles_device(small, checked_settings(P.Settings(tiles_dimension=32)), dev)
    schedule, qg, ch = args("north", s.wrap)
    planes = tiles["north"][1]
    stream = halo.forward_tile_sharded(planes, schedule, s.wavelet, s.wrap, qg, mesh2, "rows")
    rec = halo.inverse_tile_sharded(stream, schedule, s.wavelet, s.wrap, ch, mesh2, "rows")
    if (any(not np.array_equal(a, b) for a, b in zip(got, ref)) or not torch.equal(stream, out[0][0])
            or not torch.equal(rec, out[0][1])):
        raise AssertionError("parallel: the 2 x 4 mesh step differs from the one-device results")
    log("parallel: one step on a 2 x 4 (tiles, rows) mesh of cuda:0: the tile streams and the "
        "row-sharded whole tile equal to the one-device results")

    cards = torch.cuda.device_count()
    if cards > 1:
        mesh_c = make_mesh((cards,), ("rows",))
        stream = halo.forward_tile_sharded(planes, schedule, s.wavelet, s.wrap, qg, mesh_c)
        rec = halo.inverse_tile_sharded(stream, schedule, s.wavelet, s.wrap, ch, mesh_c)
        blob = ptiles.encode_image_sharded(img, st, make_mesh((cards,), ("tiles",)))
        pix, _, _ = ptiles.decode_image_sharded(blob, make_mesh((cards,), ("tiles",)))
        if (not torch.equal(stream.to(dev), out[0][0]) or not torch.equal(rec.to(dev), out[0][1])
                or blob != want_blob or not np.array_equal(pix, want_pix)):
            raise AssertionError(f"parallel: the mesh of {cards} distinct cards differs")
    log(f"parallel: {cards} CUDA device(s); "
        + ("the same results on a mesh of distinct cards" if cards > 1 else
           "no mesh of distinct cards on this machine"))
    _multihost_check(P, card)
    row = k7_times(P, dev, img, s, tiles["north"][1], st, card)
    for k in K7:
        row[k]["launches"] = launches[k]
    log(f"parallel: phase {time.perf_counter() - t0:.1f} s")
    return row


def k7_times(P, dev, img, s, planes, st, card) -> dict:
    """K7 alone on the launches of one sharded whole-tile forward (inverse)
    over 8 shards (captured from that call): device ms under the profiler,
    CUDA-event ms back to back, the plain versions' ms on the same inputs,
    per launch and per level; the bound of those launches; the sharded
    whole tile's wall and device busy ms against the one-device routes,
    and the tile-sharded encode / decode against the one-shot ones, with
    the copies each makes."""
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import tile_qg
    from ako_tpu_torch.ops import lifting
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.ops.wavelets import effective_wavelet
    from ako_tpu_torch.parallel import halo, make_mesh
    from ako_tpu_torch.parallel import tiles as ptiles

    h, w, ch = img.shape
    schedule = geometry.lift_schedule(w, h)
    qg = tile_qg(w, h, ch, s.quantization, s.gate, s.chroma_loss)
    mesh = make_mesh((8,), ("rows",), devices=[dev] * 8)
    fwd = lambda: halo.forward_tile_sharded(planes, schedule, s.wavelet, s.wrap, qg, mesh)
    stream = fwd()
    inv = lambda: halo.inverse_tile_sharded(stream, schedule, s.wavelet, s.wrap, ch, mesh)

    # the K7 launches of one call, their inputs captured
    calls = {k: [] for k in K7}
    real = {k: getattr(lk, k) for k in K7}

    def spy(name):
        def run(*a):
            calls[name].append(a)
            return real[name](*a)
        return run

    for k in K7:
        setattr(lk, k, spy(k))
    try:
        fwd()
        inv()
    finally:
        for k in K7:
            setattr(lk, k, real[k])
    torch.cuda.synchronize()
    plain = {"lift_level_shards": lk.lift_level_shards_plain,
             "unlift_level_shards": lk.unlift_level_shards_plain}
    row = {}
    for k in K7:
        fwd_k = k == "lift_level_shards"
        alone = lambda: [real[k](*a) for a in calls[k]]
        prof = _profile_until(alone)
        dev_ms = prof["per"].get(k, float("nan"))
        ev_ms = _event_ms(alone, iters=10)
        plain_ms = _event_ms(lambda: [plain[k](*a) for a in calls[k]], iters=3)
        nbytes = ops = 0
        per_level = {}
        for a in calls[k]:
            lvl_k, shards = (a[2], a[3]) if fwd_k else (a[4], a[5])
            per_level.setdefault(lvl_k, []).append(a)
            lvl = schedule.levels[lvl_k]
            T, tw, lh, lw = lvl.target_h, lvl.target_w, lvl.current_h, lvl.current_w
            weff = effective_wavelet(s.wavelet, tw, T)
            # the pairs of the launch's windows, each read once; its
            # shards' pairs and plane rows, each written (read) once
            runs = []
            for pr in shards:
                lo, wn = lk.row_window(T, pr, weff, s.wrap)
                runs += lk.pair_runs(lo, lo + wn, T, s.wrap)
            need = sum(b - a for a, b in halo._merged(runs))
            pairs = sum(p1 - p0 for p0, p1 in shards)
            rows = sum(min(2 * p1, lh) - 2 * p0 for p0, p1 in shards)
            if fwd_k:
                nbytes += 2 * (ch * min(2 * need, lh) * lw + 4 * ch * pairs * tw + ch)
            else:
                nbytes += 2 * (4 * ch * need * tw + ch + ch * rows * lw)
            ops += ch * rows * lw * 2 * LIFT_OPS
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / int_ops_per_s() * 1e3
        bound = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
        levels = {}
        for lvl_k, group in sorted(per_level.items()):
            levels[lvl_k] = (_launch_ms(lambda: [real[k](*a) for a in group], k, iters=10),
                             len(group))
        log(f"  {k}: {len(calls[k])} launches a whole-tile call over 8 shards of one card: device "
            f"{dev_ms:.4f} ms (profiler), {ev_ms:.4f} ms back to back (CUDA events), plain "
            f"{plain_ms:.4f} ms; bound {bound[0]:.5f} ms ({bound[1]}: {nbytes} B, {ops} ops); "
            f"per level (device ms per launch, median; launches): "
            f"{ {lv: (round(t, 4), n) for lv, (t, n) in levels.items()} } [{card}]")
        row[k] = {"launches": 0, "ms": round(dev_ms if dev_ms == dev_ms else ev_ms, 4),
                  "plain_ms": round(plain_ms, 4), "bound": bound}

    # the sharded whole tile against the one-device routes
    tile = torch.from_numpy(np.ascontiguousarray(img[None])).to(dev)
    one_fwd = lambda: lifting.forward_tiles(tile, schedule, s.wavelet, s.wrap, qg, s.color,
                                            bool(s.discard_non_visible))
    one_stream = one_fwd()
    routes = {
        "sharded forward (8 shards)": fwd,
        "sharded inverse (8 shards)": inv,
        "one-device forward_tiles (u8, fused route)": one_fwd,
        "one-device inverse_tiles (u8, fused route)":
            lambda: lifting.inverse_tiles(one_stream, schedule, s.wavelet, s.wrap, ch, s.color),
        "one-device forward_tile (planes, K1 a level)":
            lambda: lifting.forward_tile(planes, schedule, s.wavelet, s.wrap, qg),
        "one-device inverse_tile (planes, K2 a level)":
            lambda: lifting.inverse_tile(stream, schedule, s.wavelet, s.wrap, ch),
    }
    for name, fn in routes.items():
        before = dict(halo.COPIES)
        fn()
        copies = {k: halo.COPIES[k] - before[k] for k in before}
        r = _profile_until(fn)
        log(f"  {name}: wall {_median_ms(fn):.3f} ms (median of {RUNS}), device busy "
            f"{r['busy']:.3f} ms, {r['kernels']} kernels, {r['copies']} device copies; "
            f"halo copies {copies} [{card}]")
    for n in (8, 3):
        tmesh = make_mesh((n,), ("tiles",), devices=[dev] * n)
        blob = ptiles.encode_image_sharded(img, st, tmesh)
        enc = _median_ms(lambda: ptiles.encode_image_sharded(img, st, tmesh))
        dec = _median_ms(lambda: ptiles.decode_image_sharded(blob, tmesh))
        log(f"  tile-sharded north_t128 over {n} shards of cuda:0: encode {enc:.2f} ms, decode "
            f"{dec:.2f} ms (median of {RUNS}) [{card}]")
    blob = P.encode(img, st, device=dev)
    log(f"  one-shot north_t128: encode {_median_ms(lambda: P.encode(img, st, device=dev)):.2f} "
        f"ms, decode {_median_ms(lambda: P.decode(blob, device=dev)):.2f} ms [{card}]")
    return row


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card", file=sys.stderr)
        return 2
    card = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card}")
    dev = torch.device("cuda:0")

    import ako_tpu_torch as P
    from ako_tpu_torch.utils.corpus import corpus

    img = corpus(NORTH_STAR["seed"], 1, NORTH_STAR["h"], NORTH_STAR["w"], NORTH_STAR["ch"])[0]
    phase_build()
    oracle = {}
    for name, s in north_star_settings(P).items():
        blob = oracle_encode(img, s)
        oracle[name] = (blob, oracle_decode(blob))
    for name, s in manba_settings(P).items():
        blob = oracle_encode_manba(img, s)
        oracle[name] = (blob, oracle_decode(blob))
        # the same coefficients as the Kagari setting, coded otherwise
        if not np.array_equal(oracle[name][1], oracle[name.removesuffix("_manba")][1]):
            raise AssertionError(f"oracle {name}: pixels differ from the Kagari setting's")

    err = phase_lift_kernels(dev, [(320, 128, 128), (3, 127, 97), (3, 5, 9), (1, 1280, 1024)])
    err.update(phase_vlift_kernels(dev, vlift_shapes(img, 128)))
    err.update(phase_pyramid_kernels(dev))
    err.update(phase_level_kernels(dev))
    err["kagari_encode"] = phase_k3(P, dev, img)
    err["kagari_decode"] = phase_k4(dev, oracle["north_t128"][0])
    err.update(phase_k6(P, dev, img))
    err.update(phase_rate_kernels(P, dev, img))
    err.update(phase_parallel_kernels(dev))
    phase_goldens(P, dev)
    launches = phase_north_star(P, dev, img, oracle)
    device_ms = phase_profile(P, dev, img, card)
    times = phase_timings(P, dev, img, card)
    times["kagari_decode"] = k4_times(dev, oracle["north_t128"][0], card)
    times["kagari_encode"] = k3_times(P, dev, img, card)
    k6, k6_latency = k6_times(P, dev, img, card)
    times.update(k6)
    phase_streams(P, dev, img, card)
    phase_executor(P, dev, card)
    rate = phase_rate(P, dev, img, card)
    phase_cli(P, dev, img, rate["blobs"][RATE_ROW])
    k7 = phase_parallel(P, dev, img, oracle, card)
    bound = bounds_ms(img, oracle["north_t128"][0], oracle["north_t128_manba"][0])
    floor = launch_floor_ms(dev)
    split_launches = expected_launches(img, {"north_t128": north_star_settings(P)["north_t128"]},
                                       True, "split")
    log(f"launch floor: an empty kernel {floor:.5f} ms (device, profiler, median of 50); "
        f"north_t128 split: {split_launches['vlift']} K1v and {split_launches['vunlift']} K2v "
        f"launches an image [{card}]")
    for k in REPLACES:
        if k not in device_ms:  # no device time in the profile: CUDA events
            device_ms[k] = times[k][0]
            log(f"{k}: ms from CUDA events (kernel launch rate), not the profiler")

    # launches: each kernel's count on the path of its ROW_RUN, every
    # setting of that path (K1/K2: the whole tile's levels)
    kernels = [
        {
            "name": k,
            "route": "cuda",
            "source": SOURCES[k],
            "replaces": REPLACES[k],
            "launches": launches[ROW_RUN[k][0]][k],
            "max_abs_err": err[k],
            "ms": device_ms[k],
            "plain_ms": times[k][1],
            "bound_ms": round(bound[k][0], 5),
            "bound_by": bound[k][1],
            "library_ms": None,
        }
        for k in REPLACES
    ]
    # K6e's chain: the wire format makes it one serial chain a stream, so
    # its least time is also the steps times the step's least time; K6d's
    # lanes are chains of DECODE_BLOCK steps after two round trips
    for row in kernels:
        if row["name"] in k6_latency:
            row["latency_bound_ms"] = round(k6_latency[row["name"]], 5)
        # K1v/K2v: an image's launches, each at least an empty kernel's time
        if row["name"] in ("vlift", "vunlift"):
            row["launch_floor_ms"] = round(split_launches[row["name"]] * floor, 5)
    # K8: the launches of RATE_ROW's search, the kernels alone at one of
    # its probes on the north star's 128-px raw pyramid
    rate_bound = rate["ms"]["bound"]
    kernels += [
        {
            "name": k,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": rate["launches"][k],
            "max_abs_err": err[k],
            "ms": rate["ms"][k][0],
            "plain_ms": rate["ms"][k][1],
            "bound_ms": round(rate_bound[k][0], 5),
            "bound_by": rate_bound[k][1],
            "library_ms": None,
        }
        for k, (source, replaces) in RATE_KERNELS.items()
    ]
    # K7: the launches of the parallel phase's main path, the kernels alone
    # on the launches of one sharded whole-tile call over 8 shards
    kernels += [
        {
            "name": k,
            "route": "cuda",
            "source": K7_SOURCE,
            "replaces": replaces,
            "launches": k7[k]["launches"],
            "max_abs_err": err[k],
            "ms": k7[k]["ms"],
            "plain_ms": k7[k]["plain_ms"],
            "bound_ms": round(k7[k]["bound"][0], 5),
            "bound_by": k7[k]["bound"][1],
            "library_ms": None,
        }
        for k, replaces in K7.items()
    ]
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t0:.1f} s")
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
    try:
        if sys.argv[1:2] == ["--multihost-worker"]:
            code = multihost_worker(*sys.argv[2:])
        else:
            code = main()
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)

#!/usr/bin/env python3
"""Probes of the port on one CUDA card that go past chip_smoke.py: a
comparison with another checkout, and where kernels K3's, K4's and the
level kernels' time goes.

    python3 chip_probe.py compare OTHER   # OTHER: the root of another checkout
    python3 chip_probe.py k3 [OTHER]
    python3 chip_probe.py k4 [OTHER]
    python3 chip_probe.py levels [OTHER]

compare: the device-entropy north star (128-px tiles, fused wiring) in
turns OTHER, this, this, OTHER, each in its own process: encode and
decode medians (two of 7 runs each), one profiled encode and decode
(wall, host enqueue, device busy ms, device ms per kernel), their event
stages on the host clock, and K4 alone (CUDA events); then the same for
the default whole-image tile, its encode.forward_streams and
decode.stream_pixels calls (host enqueue and device span medians, one
profiled call's device busy ms, device kernels and top-level torch ops),
and its decode's device events one by one (start and ms).
OTHER is unpacked with `git archive` into a directory that git ignores
(build/).

k3: variants of csrc/kagari_encode.cu, made by editing its source and
built with nvcc side by side: as it is (256 threads x 16 items, five
CTAs a SM); 512 threads x 8 items at four CTAs a SM; six, four and three
CTAs a SM; then, to show their shares, no zero-tail CTAs, no merge of
the shared edge words, no packing of the codes; and OTHER's
kagari_encode.cu as it is when OTHER is given (an earlier checkout's
three-launch kernel too). Each variant that computes the function is
checked against the plain version; all are timed, in turns, on the
north star's 80 streams at 128-px tiles and on the default whole tile's
one stream: device ms a call (the profiler, every device kernel of 20
calls) and CUDA events around 50 calls.

k4: variants of csrc/kagari_decode.cu, made by editing its source and
built with nvcc side by side, timed on the north star's decode inputs
at 128-px tiles, q=16 and lossless (device ms: the profiler's median of
20 launches; CUDA events around 50), in turns:
  staged     the kernel as it is (every CTA of these inputs staged)
  pool       every CTA on the route that reads the pool
  no_decode  the staging copy and the stores, no lane decoded
  no_store   the staging and the decode, no store to device memory
  one_cta    the first CTA alone: one CTA's chain of 128 steps
  other      OTHER's kagari_decode.cu as it is, when OTHER is given
Each variant that computes the function is checked against the plain
version.

levels: variants of csrc/lift_level.cu with 512, 256 and 128 threads a
CTA (kThreads edited in the source), and OTHER's lift_level.cu as it is
when OTHER is given (its LevelArgs a leading part of this one's), built
with nvcc side by side, on the default whole tile's levels before its
pyramid start (the north star, 1024x1280 RGBA, q=16): for each variant,
level and region of ops/lift_kernels.py LEVEL_REGIONS whose CTA the
kernel takes, the CTAs, lift_level's and unlift_level's device ms (the
profiler's median of 20 launches), each checked against the plain
version; and K1/K2 (lift2d.cu) on the same levels for comparison. Then
the route the level kernels replaced (the torch colour transform and
quantize ops around K1, the dequantize and colour ops around K2) against
forward_levels / inverse_levels, on the whole tile's levels 0-2, the
north star's 256-px tiles' level 0 and 80 random 9-channel 128-px tiles
(every level): device busy ms of one profiled call and its device
kernels, each route checked against the other. Every line carries the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "probe")  # ignored by git

CHILD = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
import ako_tpu_torch as P
from ako_tpu_torch.ops import kagari_device as kd
from ako_tpu_torch.utils.corpus import corpus

assert os.path.dirname(P.__file__).startswith(sys.argv[1]), P.__file__
dev = torch.device("cuda:0")
img = corpus(42, 1, 1280, 1024, 4)[0]
s = P.Settings(quantization=16, tiles_dimension=128)
out = {"encode_ms": [], "decode_ms": []}
blob = P.encode(img, s, device=dev, device_entropy=True)
for _ in range(2):
    out["encode_ms"].append(round(cs._median_ms(
        lambda: P.encode(img, s, device=dev, device_entropy=True)), 3))
    out["decode_ms"].append(round(cs._median_ms(
        lambda: P.decode(blob, device=dev, device_entropy=True)), 3))
calls = {
    "encode": lambda cb=None: P.encode(img, s, cb, device=dev, device_entropy=True),
    "decode": lambda cb=None: P.decode(blob, cb, device=dev, device_entropy=True),
}
for direction, fn in calls.items():
    r = cs._profile_window(fn)
    out[direction] = {"wall": round(r["wall"], 3), "enqueue": round(r["enqueue"], 3),
                      "busy": round(r["busy"], 4), "device_events": r["events"],
                      "per": {k: round(v, 4) for k, v in r["per"].items()},
                      "stages": cs._stage_ms(fn)}
parts, n, _ = cs.entropy_inputs(blob, dev)[0]
out["k4_event_ms"] = round(cs._event_ms(lambda: kd.kagari_decode_device(*parts, n)), 4)

from ako_tpu_torch.decode import stream_pixels
from ako_tpu_torch.encode import checked_settings, forward_streams

sw = P.Settings()
bw = P.encode(img, sw, device=dev, device_entropy=True)
whole = {"encode_ms": round(cs._median_ms(lambda: P.encode(img, sw, device=dev, device_entropy=True)), 3),
         "decode_ms": round(cs._median_ms(lambda: P.decode(bw, device=dev, device_entropy=True)), 3)}
for direction, fn in (("encode", lambda: P.encode(img, sw, device=dev, device_entropy=True)),
                      ("decode", lambda: P.decode(bw, device=dev, device_entropy=True))):
    r = cs._profile_window(fn)
    whole[direction] = {"wall": round(r["wall"], 3), "enqueue": round(r["enqueue"], 3),
                        "busy": round(r["busy"], 4), "kernels": r["kernels"], "ops": r["ops"],
                        "per": {k: round(v, 4) for k, v in r["per"].items()}}
h, w, ch = img.shape
cw = checked_settings(sw)
tiles = torch.from_numpy(img[None].copy()).to(dev)
streams = forward_streams(tiles, w, h, ch, cw)
for name, fn in (("forward_streams", lambda: forward_streams(tiles, w, h, ch, cw)),
                 ("stream_pixels", lambda: stream_pixels(streams, w, h, ch, cw))):
    r = cs._profile_window(fn)
    whole[name] = {"enqueue": round(cs._enqueue_ms(fn), 3), "span": round(cs._span_ms(fn), 4),
                   "busy": round(r["busy"], 4), "kernels": r["kernels"], "ops": r["ops"],
                   "per": {k: round(v, 4) for k, v in r["per"].items()}}
# the whole tile's decode, event by event: (device event, ms from the
# first device event to its start, its ms)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    P.decode(bw, device=dev, device_entropy=True)
    torch.cuda.synchronize()
events = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                if e.device_type == DeviceType.CUDA)
whole["decode_events"] = [(name[:48], round((a - events[0][0]) / 1e3, 4), round((b - a) / 1e3, 4))
                          for a, b, name in events]
out["default_whole"] = whole
print("RESULT " + json.dumps(out), flush=True)
'''


def compare(other: str, card: str) -> None:
    other = os.path.realpath(other)
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        res = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True,
                             cwd=root, timeout=600)
        line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")]
        if res.returncode or not line:
            raise RuntimeError(f"compare {name} failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        print(f"{name} {line[0][len('RESULT '):]} [{card}]", flush=True)


STORE_LOOP = "    for (long long v = (g0 & ~7LL) + 8LL * tid; v < g1; v += 8LL * kLanes) {"
#: variant name -> (old, new) source edits of csrc/kagari_decode.cu, and
#: whether it still computes the function
K4_VARIANTS = {
    "staged": ([], True),
    "pool": ([("(span > 0 && span <= kSpanWords)", "(span < 0)")], True),
    "no_decode": ([("    if (active) {\n", "    if (active && n_outputs < 0) {\n")], False),
    "no_store": ([(STORE_LOOP, "    if (tid == 0) out[g0] = (int16_t)out16[0];\n"
                               "    for (long long v = g1; v < g1; v += 8LL * kLanes) {")], False),
    "one_cta": ([("kagari_decode<<<(unsigned)grid,", "kagari_decode<<<1u,")], False),
}


def _k4_sources(other):
    from ako_tpu_torch.runtime import kernels

    src = open(os.path.join(ROOT, "ako_tpu_torch", "csrc", "kagari_decode.cu")).read()
    out = {}
    for name, (edits, exact) in K4_VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"k4 variant {name}: the source has no {old!r}")
            text = text.replace(old, new)
        out[name] = (text, exact)
    if other:
        out["other"] = (open(os.path.join(other, "ako_tpu_torch", "csrc", "kagari_decode.cu")).read(),
                        True)
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (text, _) in out.items():
        cu, so = os.path.join(OUT, f"k4_{name}.cu"), os.path.join(OUT, f"k4_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on k4 variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.ako_kagari_decode.restype = ctypes.c_int
        lib.ako_kagari_decode.argtypes = kernels._SIGNATURES["ako_kagari_decode"]
        regs = [x.split("info    :")[-1].strip() for x in log.splitlines() if "registers" in x]
        print(f"k4 {name}: {regs}", flush=True)
        libs[name] = (lib, out[name][1])
    return libs


def k4(other, card: str) -> None:
    import numpy as np
    import torch

    import ako_tpu_torch as P
    import chip_smoke as cs
    from ako_tpu_torch.ops import kagari_device as kd
    from ako_tpu_torch.utils.corpus import corpus

    libs = _k4_sources(other)
    dev = torch.device("cuda:0")
    img = corpus(42, 1, 1280, 1024, 4)[0]
    for setting in ("north_t128", "lossless_t128"):
        blob = cs.oracle_encode(img, cs.north_star_settings(P)[setting])
        ((pool, base, bit_off, prev, consec, run), n, span), = cs.entropy_inputs(blob, dev)
        T, B = bit_off.shape
        ref = kd._decode_plain(pool, base, bit_off, prev, consec, run, n, kd.DECODE_BLOCK, span)
        spans = kd.decode_cta_spans(base.cpu().numpy(), bit_off.cpu().numpy(), pool.shape[0])
        print(f"k4 {setting}: {len(spans['staged'])} CTAs, {int(spans['staged'].sum())} staged, "
              f"words a CTA median {float(np.median(spans['words']))} max {int(spans['words'].max())}",
              flush=True)
        rows = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            lib, exact = libs[name]
            out = torch.empty((T, n), dtype=torch.int16, device=dev)

            def call():
                rc = lib.ako_kagari_decode(pool.data_ptr(), pool.shape[0], base.data_ptr(),
                                           bit_off.data_ptr(), prev.data_ptr(), consec.data_ptr(),
                                           run.data_ptr(), out.data_ptr(), T, B, n, kd.DECODE_BLOCK,
                                           torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"k4 variant {name}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            if exact and not torch.equal(out, ref):
                raise AssertionError(f"k4 variant {name} != plain on {setting}")
            rows[name].append((round(cs._launch_ms(call, "kagari_decode"), 4),
                               round(cs._event_ms(call), 4)))
        for name, times in rows.items():
            print(f"k4 {setting} {name}: (profiler ms, event ms) {times} [{card}]", flush=True)


#: variant name -> (old, new) source edits of csrc/kagari_encode.cu
#: (threads a CTA, items a thread, CTAs a SM, look-back width, spin), and
#: whether it still computes the function (the others drop a part to
#: show its share)
K3_VARIANTS = {
    "t256_i16": ([], True),
    "t512_i8": ([("kThreads = 256;", "kThreads = 512;"), ("kItems = 16;", "kItems = 8;"),
                 ("kMinBlocks = 5;", "kMinBlocks = 4;")], True),
    "min6": ([("kMinBlocks = 5;", "kMinBlocks = 6;")], True),
    "min4": ([("kMinBlocks = 5;", "kMinBlocks = 4;")], True),
    "min3": ([("kMinBlocks = 5;", "kMinBlocks = 3;")], True),
    "no_zero": ([("        zero_tail(a, s_ticket - chunk_ctas);", "        ;")], False),
    "no_merge": ([("        merge_edges(a, row, reinterpret_cast<uint2*>(buf));", "        ;")], False),
    "no_pack": ([("    pack(codes, off, buf);\n", "")], False),
}


def _k3_sources(other):
    """{variant: (ctypes library, chunk positions, new ABI)}: K3_VARIANTS
    built side by side, and OTHER's kagari_encode.cu as it is ("other";
    the three-launch kernel of earlier checkouts takes an int32 scratch
    and no epoch)."""
    import re

    from ako_tpu_torch.runtime import kernels

    src = open(os.path.join(ROOT, "ako_tpu_torch", "csrc", "kagari_encode.cu")).read()
    texts = {}
    for name, (edits, _) in K3_VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"k3 variant {name}: the source has no {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    if other:
        texts["other"] = open(os.path.join(other, "ako_tpu_torch", "csrc", "kagari_encode.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, so = os.path.join(OUT, f"k3_{name}.cu"), os.path.join(OUT, f"k3_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on k3 variant {name}:\n{log}")
        text = texts[name]
        threads = int(re.search(r"kThreads = (\d+);", text).group(1))
        items = int(re.search(r"kItems = (\d+);", text).group(1))
        new_abi = "unsigned epoch" in text
        lib = ctypes.CDLL(so)
        lib.ako_kagari_encode.restype = ctypes.c_int
        lib.ako_kagari_encode.argtypes = (kernels._SIGNATURES["ako_kagari_encode"] if new_abi else
                                          [ctypes.c_void_p] * 4 + [ctypes.c_longlong] +
                                          [ctypes.c_int] * 3 + [ctypes.c_void_p])
        regs = [x.split("info    :")[-1].strip() for x in log.splitlines() if "registers" in x]
        print(f"k3 {name}: chunk {threads * items}, {regs}", flush=True)
        libs[name] = (lib, threads * items, new_abi, K3_VARIANTS.get(name, (None, True))[1])
    return libs


def k3(other, card: str) -> None:
    """K3's variants (and OTHER's kernel) on the north star's streams at
    128-px tiles and on the default whole tile's stream, in turns: device
    ms per call (the profiler: every device kernel of 20 calls, over 20)
    and CUDA events around 50 calls, each variant checked against the
    plain version."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ako_tpu_torch as P
    import chip_smoke as cs
    from ako_tpu_torch.ops import kagari_device as kd
    from ako_tpu_torch.utils.corpus import corpus

    libs = _k3_sources(other)
    dev = torch.device("cuda:0")
    img = corpus(42, 1, 1280, 1024, 4)[0]
    cur = torch.cuda.current_stream().cuda_stream
    epoch = [0]
    for setting in ("north_t128", "default_whole"):
        ((streams, cap, budget),) = cs.group_streams(dev, img, cs.north_star_settings(P)[setting])
        rows, n = streams.shape
        ref, ref_total = cs.k3_plain(streams, budget)
        row_words = -(-budget // 4)
        chunks_cap = rows * -(-n // 512)
        scratch = torch.zeros((kd.scratch_words(rows, chunks_cap),), dtype=torch.int64, device=dev)
        old_scratch = torch.empty((2 * chunks_cap,), dtype=torch.int32, device=dev)
        rows_out = {name: [] for name in libs}
        for name in list(libs) + list(libs)[::-1]:
            lib, _, new_abi, exact = libs[name]
            out = torch.empty((rows, row_words * 4), dtype=torch.uint8, device=dev)
            totals = torch.empty((rows,), dtype=torch.int64, device=dev)

            def call():
                if new_abi:
                    epoch[0] += 1
                    rc = lib.ako_kagari_encode(streams.data_ptr(), out.data_ptr(), totals.data_ptr(),
                                               scratch.data_ptr(), scratch.numel(), rows, chunks_cap,
                                               epoch[0], rows, n, row_words, cur)
                else:
                    rc = lib.ako_kagari_encode(streams.data_ptr(), out.data_ptr(), totals.data_ptr(),
                                               old_scratch.data_ptr(), old_scratch.numel(), rows, n,
                                               row_words, cur)
                if rc:
                    raise RuntimeError(f"k3 variant {name}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            if exact and not (torch.equal(out[:, :budget], ref) and torch.equal(totals, ref_total)):
                raise AssertionError(f"k3 variant {name} != plain on {setting}")
            call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            spans = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            dev_ms = sum(e.time_range.end - e.time_range.start for e in spans) / 1e3 / 20
            rows_out[name].append((round(dev_ms, 4), round(cs._event_ms(call), 4), len(spans) // 20))
        for name, times in rows_out.items():
            print(f"k3 {setting} {tuple(streams.shape)} budget {budget} {name} (chunk "
                  f"{libs[name][1]}): (profiler ms a call, event ms, device kernels a call) {times} "
                  f"[{card}]", flush=True)


LEVEL_THREADS = (512, 256, 128)


def _level_sources(other):
    """{variant: ctypes library}: csrc/lift_level.cu with kThreads edited
    ("t512", "t256", "t128"), and OTHER's as it is ("other")."""
    from ako_tpu_torch.runtime import kernels

    csrc = os.path.join(ROOT, "ako_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "lift_level.cu")).read()
    old = "constexpr int kThreads = 512;"
    if old not in src:
        raise RuntimeError(f"levels: the source has no {old!r}")
    variants = {f"t{t}": (src.replace(old, f"constexpr int kThreads = {t};"), csrc)
                for t in LEVEL_THREADS}
    if other:
        ocsrc = os.path.join(other, "ako_tpu_torch", "csrc")
        variants["other"] = (open(os.path.join(ocsrc, "lift_level.cu")).read(), ocsrc)
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (text, inc) in variants.items():
        cu, so = os.path.join(OUT, f"level_{name}.cu"), os.path.join(OUT, f"level_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", inc, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the level variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn_name in ("ako_lift_level", "ako_unlift_level"):
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = kernels._SIGNATURES[fn_name]
        regs = [x.split("info    :")[-1].strip() for x in log.splitlines() if "registers" in x]
        print(f"levels {name}: {regs}", flush=True)
        libs[name] = lib
    return libs


def levels(other, card: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import checked_settings, tile_qg
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.ops import wavelets
    from ako_tpu_torch.utils.corpus import corpus

    import ako_tpu_torch as P

    libs = _level_sources(other)
    dev = torch.device("cuda:0")
    img = corpus(42, 1, 1280, 1024, 4)[0]
    h, w, ch = img.shape
    s = checked_settings(P.Settings(quantization=16))
    schedule = geometry.lift_schedule(w, h)
    start = lk.pyramid_start(schedule, ch)
    qg = tuple(tile_qg(w, h, ch, s.quantization, s.gate, s.chroma_loss))
    fwd = (s.wavelet, s.wrap, qg, s.color, bool(s.discard_non_visible))
    inv = (s.wavelet, s.wrap, ch, s.color)
    x = torch.from_numpy(np.ascontiguousarray(img[None])).to(dev)
    ref_stream = torch.zeros((1, schedule.coeff_count(ch)), dtype=torch.int16, device=dev)
    xs = [x]
    for k in range(start):
        xs.append(lk.forward_levels_plain(xs[-1], ref_stream, schedule, range(k, k + 1), *fwd))
    cur = torch.cuda.current_stream().cuda_stream
    for k in range(start):
        lvl = schedule.levels[k]
        weff = wavelets.effective_wavelet(s.wavelet, lvl.target_w, lvl.target_h)
        planes = lk.to_planar_yuv(x, s.color, fwd[4]).contiguous() if k == 0 else xs[k]
        k1 = cs._launch_ms(lambda: lk.lift2d_level(weff, s.wrap, planes, lvl, "fused"), "lift_h") + \
            cs._launch_ms(lambda: lk.lift2d_level(weff, s.wrap, planes, lvl, "fused"), "lift_v")
        quads = lk.wavelets.lift2d(weff, s.wrap, planes, lvl)
        k2 = cs._launch_ms(lambda: lk.unlift2d_level(weff, s.wrap, *quads, lvl, "fused"), "unlift_v") + \
            cs._launch_ms(lambda: lk.unlift2d_level(weff, s.wrap, *quads, lvl, "fused"), "unlift_h")
        print(f"levels level {k} {lvl.current_h}x{lvl.current_w}x{ch}: K1 {k1:.4f} ms, K2 {k2:.4f} ms "
              f"(lift2d.cu, profiler) [{card}]", flush=True)
        ref_out = lk.inverse_levels_plain(xs[k + 1], ref_stream, schedule, range(k, k + 1), *inv)
        for variant, lib in libs.items():
            for region in lk.LEVEL_REGIONS:
                stream = torch.zeros_like(ref_stream)
                ll = torch.empty_like(xs[k + 1])
                out = torch.empty_like(ref_out)
                fa = lk._level_args(schedule, k, ch, s.wavelet, s.wrap, qg, s.color, fwd[4],
                                    ll.stride(0), region)
                ia = lk._level_args(schedule, k, ch, s.wavelet, s.wrap, None, s.color, False,
                                    ll.stride(0), region)

                def lift():
                    rc = lib.ako_lift_level(ctypes.byref(fa), xs[k].data_ptr(), stream.data_ptr(),
                                            ll.data_ptr(), 1, cur)
                    if rc:
                        raise RuntimeError(f"lift_level: cudaError {rc}")

                def unlift():
                    rc = lib.ako_unlift_level(ctypes.byref(ia), xs[k + 1].data_ptr(),
                                              ref_stream.data_ptr(), out.data_ptr(), 1, cur)
                    if rc:
                        raise RuntimeError(f"unlift_level: cudaError {rc}")

                try:
                    lift()
                    unlift()
                except RuntimeError as e:
                    print(f"levels {variant} level {k} region {region}: not taken ({e})", flush=True)
                    continue
                torch.cuda.synchronize()
                chunk = slice(lk.level_offsets(schedule, ch)[k],
                              lk.level_offsets(schedule, ch)[k] + ch * (1 + 3 * lvl.target_h * lvl.target_w))
                if not (torch.equal(ll, xs[k + 1]) and torch.equal(stream[:, chunk], ref_stream[:, chunk])
                        and torch.equal(out, ref_out)):
                    raise AssertionError(f"levels {variant} level {k} region {region} != plain")
                ctas = -(-lvl.target_h // region[0]) * -(-lvl.target_w // region[1])
                print(f"levels {variant} level {k} region {region}: {ctas} CTAs, lift_level "
                      f"{cs._launch_ms(lift, 'lift_level'):.4f} ms, unlift_level "
                      f"{cs._launch_ms(unlift, 'unlift_level'):.4f} ms [{card}]", flush=True)
    level_routes(dev, img, s, card)


def level_routes(dev, img, s, card) -> None:
    """The route the level kernels replaced against forward_levels /
    inverse_levels (see the module's doc) on three groups."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import tile_qg
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.ops.colorspace import to_interleaved_u8, to_planar_yuv

    h, w, _ = img.shape
    rng = np.random.default_rng(9)
    groups = [
        ("whole tile levels 0-2", img[None], range(3)),
        ("256-px tiles level 0", np.stack([img[y : y + 256, x : x + 256]
                                           for y in range(0, h, 256) for x in range(0, w, 256)]),
         range(1)),
        ("9-channel 128-px tiles", rng.integers(0, 256, size=(80, 128, 128, 9), dtype=np.uint8),
         None),
    ]
    for name, tiles, levels in groups:
        n, th, tw, ch = tiles.shape
        schedule = geometry.lift_schedule(tw, th)
        levels = levels or range(len(schedule.levels))
        last = levels.stop == len(schedule.levels)
        qg = tuple(tile_qg(tw, th, ch, s.quantization, s.gate, s.chroma_loss))
        x = torch.from_numpy(np.ascontiguousarray(tiles)).to(dev)
        old_s, new_s = (torch.zeros((n, schedule.coeff_count(ch)), dtype=torch.int16, device=dev)
                        for _ in range(2))
        discard = bool(s.discard_non_visible)

        def old_fwd():
            planes = to_planar_yuv(x, s.color, discard).contiguous()
            ll = lk.lift_levels(planes, old_s, schedule, levels, s.wavelet, s.wrap, qg,
                                lk.lift2d_level)
            if last:
                lk.store_lp(old_s, ll)
            return ll

        def new_fwd():
            return lk.forward_levels(x, new_s, schedule, levels, s.wavelet, s.wrap, qg, s.color,
                                     discard)

        top = old_fwd().contiguous()
        if not (torch.equal(new_fwd(), top) and torch.equal(old_s, new_s)):
            raise AssertionError(f"routes: forward_levels != the K1 route on {name}")

        def old_inv():
            planes = lk.unlift_levels(top, old_s, schedule, levels, s.wavelet, s.wrap,
                                      lk.unlift2d_level)
            return to_interleaved_u8(planes, s.color, ch).contiguous()

        def new_inv():
            return lk.inverse_levels(top, new_s, schedule, levels, s.wavelet, s.wrap, ch, s.color)

        if not torch.equal(old_inv(), new_inv()):
            raise AssertionError(f"routes: inverse_levels != the K2 route on {name}")
        for label, fn in (("K1 route", old_fwd), ("forward_levels", new_fwd),
                          ("K2 route", old_inv), ("inverse_levels", new_inv)):
            r = cs._profile_window(fn)
            print(f"routes {name} ({n} tiles {tw}x{th}x{ch}, levels {levels.start}-"
                  f"{levels.stop - 1}): {label} device busy {r['busy']:.4f} ms, "
                  f"{r['kernels']} device kernels [{card}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2 or sys.argv[1] not in (
            "compare", "k3", "k4", "levels"):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    card = cs.nvidia_smi()
    print(card, flush=True)
    other = sys.argv[2] if len(sys.argv) > 2 else None
    if sys.argv[1] == "compare":
        if not other:
            print(__doc__, file=sys.stderr)
            return 2
        compare(other, card)
    elif sys.argv[1] == "levels":
        levels(other, card)
    elif sys.argv[1] == "k3":
        k3(other, card)
    else:
        k4(other, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

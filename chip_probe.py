#!/usr/bin/env python3
"""Probes of the port on one CUDA card that go past chip_smoke.py: a
comparison with another checkout, and where kernels K3's, K4's, K6e's,
K6d's, the level kernels' and the split wiring's K1v/K2v time goes.

    python3 chip_probe.py compare OTHER   # OTHER: the root of another checkout
    python3 chip_probe.py k3 [OTHER]
    python3 chip_probe.py k4 [OTHER]
    python3 chip_probe.py levels [OTHER]
    python3 chip_probe.py k6 [OTHER]
    python3 chip_probe.py k6d [OTHER]
    python3 chip_probe.py k8 [OTHER]
    python3 chip_probe.py split [OTHER]
    python3 chip_probe.py profiler
    python3 chip_probe.py executor

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
when OTHER is given (an OTHER whose LevelArgs ends in fields the
whole-plane kernels do not read gets this one's padded with zeros), built
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

k6: K6e's chain step (csrc/manba_encode.cu) in variants made by editing
its source, built with nvcc side by side: as it is ("new": one
multiply-high on the state as it comes in, beside the renorm compares,
then the three candidate next states, of which the compares pick one;
groups of eight steps, each group's entries loaded while the group
before it runs), "no_pipe" (each group's entries loaded at its start),
"g4" (groups of four steps), "lb1" (manba_chain_pack's launch bounds at
one CTA a SM, which lets ptxas take more registers), "old_step" (the
step before this one: renorm, then umulhi(2x, m) >> l, then the
multiply-add, in the same kernel and table), and OTHER's
manba_encode.cu as it is. For each: cuobjdump's SASS of the chain loop
of manba_chain_pack and of the chain alone (instructions a step, the
stall cycles the compiler's control bits set a step, the dependent path
a step in operations and in cycles; the SASS written to
build/probe/k6_sass_<variant>.txt); the latencies of the step's
operations (manba_op_chain: dependent chains of the multiply-high, a
shift by a register, a compare and select, a select, a multiply-add, an
add and a logic operation in turns; their loops' SASS checked); then in
turns (each variant, then again in reverse): the chain alone on the
north star's tile 0 stream (cycles, ns and the SM clock a step from the
card's clocks; OTHER's fixed-symbol probe where it has no such entry
point), and K6e on the north star's 80 streams and the whole tile's
stream (device ms of manba_chain_pack with and without the pack CTAs
beside the chains, and of the three launches; CUDA events), every
variant's record and rANS row checked against the plain version (north
star) and the native coder. nvidia-smi's SM clock is read while the
whole tile's encodes run. Last, each variant's latency bound: the
longer of its dependent path and its instructions a step, at the SM
clock the chain alone read, times the steps of one chain.

k6d: K6d, the Manbavaran block decoder (csrc/manba_decode.cu), in
variants made by editing its source (K6D_NEW), built with nvcc side by
side: set-up alone (records, frequencies and the table), with the
windows' starts, the chain without its output stores, as it is, what its
loads cost (no_guard, no_loads, no_lds, no_conflict, ca_loads,
prefetch), and as it is with each CTA's clocks (clocked); OTHER's
manba_decode.cu too, as it is. For each: ptxas's registers, the chain
loop's SASS (build/probe/k6d_sass_<checkout>_<variant>.txt; instructions
a step, the stall cycles its control bits set a step, the dependent path
through the table's load at the measured latencies of
ako_manba_op_latency: the step's operations and the shared-memory and L2
loads); then in turns (each variant, then again in reverse) its device ms
on the north star's 80 streams (q=16, 128-px tiles) and the whole tile's
stream (profiler, median of 20 launches; CUDA events around 50), every
variant that computes the function checked against the streams, and for
the clocked variant each CTA's clock64 to its table's end and its end and
its SM clock; nvidia-smi's SM clock while the whole tile's decodes run. With a full checkout as OTHER,
last, each checkout in its own process in turns (other, this, this,
other): K6d through manba_decode_device on both settings (profiler, two
medians of 20, and CUDA events) and the device-entropy decode of
north_t128_manba (AKO_TPU_MANBAVARAN=1): decode ms (median of 7) and its
COMPRESSION span (host clock, median of 7).

executor: where the streaming executor's time goes on the card's host,
at the north star's 128-px tiles (q=16, bench.py's 12-image stream):
the sync scans of one image serial and on pools of 1, 2, 4 and
os.cpu_count() threads, the upload packing, the pixel placement and the
staging copy into pinned memory (host clock, medians of 5); cProfile's
heaviest functions (own time) over 3 one-shot encodes and 3 one-shot
decodes; the sequential executor stream (4 workers) with its stages
timed by wrappers on every thread (ms an image, summed over threads),
beside its wall time an image; then in turns the one-shot loop and the
executor's streams (4 and os.cpu_count() workers, torch at one intra-op
thread, the slot's uploads copied by torch instead of numpy, the slots'
waits spinning on a core instead of blocking, roundtrip): wall and the
process's CPU time an image, encode and decode apart.

split: the split wiring's K1v/K2v (csrc/vlift.cu) on the north star's
128-px tile group (80 RGBA tiles, 320 planes), level by level, in turns
(other, this, this_3, this_3, this, other): "this" as the wiring runs
them (the pass along -1, then both halves' passes along -2 in one
launch: two launches a level each way), "this_3" the same kernels in
three launches a level (one call a launch), and "other" OTHER's K1v/K2v
(built from its csrc/lift2d.cu) wired as its split wiring was, with the
torch transposes between its three launches a level. For each: the
device ms a level of the K1v (K2v) launches and of all device work
(busy), and its device kernels (the profiler over 20 calls; every
variant checked against the plain version); the sums over the levels.
Then the launch floor, an empty kernel's device ms (median of 50); then
variants of csrc/vlift.cu made by editing its source (runs a CTA: 8 as
it is, 4, 2; "mem_only", the tiles' loads and stores without the lift;
"setup_only", each CTA's index arithmetic alone; "load_only", up to the
tile's load and its barrier),
in turns, each checked against the plain version (but mem_only), with a
torch clone of the level's plane beside them, their SASS written to
build/probe/vlift_sass_<variant>.txt; and
encode.forward_streams / decode.stream_pixels and the device-entropy
encode / decode in AKO_TORCH_LIFT_MODE=split on OTHER's checkout and
this one, each in its own process, in turns (other, this, this,
other): device busy, wall, device kernels and device ms per kernel of
one profiled call, host enqueue and device span medians, and the
streams' and pixels' digests, which must agree.

k8: K8p and K8s (csrc/rate.cu) of this checkout and of OTHER's (its
rate.cu, and kagari_encode.cu while K8p lived there), built side by side
into separate libraries, with K8_ROUTES appended to this checkout's: the
kernels' common routes in loops, whose SASS gives the instructions a
value of K8s's 16-byte route, of K8p's stage without the tokenizer
("skip": no warp tokenizes) and what the tokenizer adds ("tok": every
warp does), both without the route of heads, segments' ends and
spans' edges (which the fast route's loop would hold untaken), written with each
library's SASS to
build/probe/k8_sass_<variant>.txt. Then both checkouts' kernels, each
checked against its plain version, timed in turns (other, new, new,
other) on the north star's raw pyramid at 128-px tiles and on the whole
tile's, at q 0, 16, 64 and 256: device ms a launch (the profiler's median
of 20) and CUDA events around 50, beside the bounds and each kernel's
SASS instructions a value; then K8p's variants, and K8p against its
whole-CTA row finisher in 3 rounds of turns at q 0-256 on the north
star. CUPTI is torn down after each profiled window, as chip_smoke.py
does.

profiler: how often torch.profiler records a short window's device work
as the process ages, in two child processes, one with CUPTI kept up
across windows as torch leaves it (TEARDOWN_CUPTI=0), one with CUPTI torn
down after each window (=1, as chip_smoke.py sets it). Each child: the
host's launch calls and the device events of one split level; then 10
windows a case, in turns, at the start and after 100 s: K3 alone on the
north star's 80 streams, the fused wiring's forward_streams on its 80
tiles (one lift_pyramid launch), one empty kernel (csrc/vlift.cu
launch_floor) and one torch op, each in a window as
chip_smoke._profile_window makes it (a warm call, then one call and a
synchronize under the profiler; "as_is"), with 2 ms of host sleep
between the profiler's start and the call ("settle"), and with the
device activity alone ("cuda_only"): the windows that recorded none of
the call's device events, fewer, and all of them. Between the two, every
10 s for 100 s: the host's realtime clock against its monotonic one, and
one window around a torch op, an empty kernel and K3 padded by 0, 0.05,
0.5 and 2 s of host sleep at each end: its device events, its host
launch calls, and the first device event's start less the first launch
call's.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time

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


def _padded(args):
    """A LevelArgs followed by 64 zero bytes, as a LevelArgs pointer: a
    checkout whose table is longer reads zeros past this one's."""
    from ako_tpu_torch.runtime import kernels

    buf = ctypes.create_string_buffer(bytes(args) + bytes(64))
    ptr = ctypes.cast(buf, ctypes.POINTER(kernels.LevelArgs))
    ptr._buf = buf  # kept alive with the pointer
    return ptr


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
                fa = _padded(lk._level_args(schedule, k, ch, s.wavelet, s.wrap, qg, s.color,
                                            fwd[4], ll.stride(0), region))
                ia = _padded(lk._level_args(schedule, k, ch, s.wavelet, s.wrap, None, s.color,
                                            False, ll.stride(0), region))

                def lift():
                    rc = lib.ako_lift_level(fa, xs[k].data_ptr(), stream.data_ptr(),
                                            ll.data_ptr(), 1, cur)
                    if rc:
                        raise RuntimeError(f"lift_level: cudaError {rc}")

                def unlift():
                    rc = lib.ako_unlift_level(ia, xs[k + 1].data_ptr(),
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


NEW_STEP = """    const uint32_t hi = __umulhi(x, t.a.x);
    const bool e0 = x >= t.a.y, e1 = x >= t.a.z;
    const uint32_t x0 = mad(hi >> t.b.y, t.a.w, x + t.b.x);
    const uint32_t x1 = mad(hi >> t.b.z, t.a.w, (x >> 8) + t.b.x);
    const uint32_t x2 = mad(hi >> t.b.w, t.a.w, (x >> 16) + t.b.x);
    return e1 ? x2 : (e0 ? x1 : x0);
"""
PIPELINED = """    Entry ta[kGroup], tb[kGroup];
    load_group(ta, tab, group_offsets(so, g));
    GroupOffsets oa, ob_next = group_offsets(so, max(g - 1, 0));
    for (;;) {
        load_group(tb, tab, ob_next);
        oa = group_offsets(so, max(g - 2, 0));
        x = run_group(x, ta, xs + kGroup * g);
        if (--g < 0) break;
        load_group(ta, tab, oa);
        ob_next = group_offsets(so, max(g - 2, 0));
        x = run_group(x, tb, xs + kGroup * g);
        if (--g < 0) break;
    }
"""
#: variant name -> (old, new) source edits of csrc/manba_encode.cu; each
#: computes the function
K6_VARIANTS = {
    "new": [],
    "no_pipe": [(PIPELINED, """    for (; g >= 0; --g) {
        Entry t[kGroup];
        load_group(t, tab, group_offsets(so, g));
        x = run_group(x, t, xs + kGroup * g);
    }
""")],
    "old_step": [(NEW_STEP, """    const bool e0 = x >= t.a.y, e1 = x >= t.a.z;
    x = e1 ? x >> 16 : (e0 ? x >> 8 : x);
    const uint32_t q = __umulhi(x + x, t.a.x) >> (t.b.z - 7);
    return x + t.b.x + q * t.a.w;
""")],
}


K6_VARIANTS["g4"] = [("constexpr int kGroup = 8;", "constexpr int kGroup = 4;")]
K6_VARIANTS["lb1"] = [("__global__ void __launch_bounds__(kThreads)\nmanba_chain_pack(",
                       "__global__ void __launch_bounds__(kThreads, 1)\nmanba_chain_pack(")]


def _k6_sources(other):
    """{variant: (ctypes library, SASS text)}: K6_VARIANTS and OTHER's
    manba_encode.cu as it is ("other"), built side by side."""
    import chip_smoke as cs
    from ako_tpu_torch.runtime import kernels

    src = open(os.path.join(ROOT, "ako_tpu_torch", "csrc", "manba_encode.cu")).read()
    texts = {}
    for name, edits in K6_VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"k6 variant {name}: the source has no {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    if other:
        texts["other"] = open(os.path.join(other, "ako_tpu_torch", "csrc", "manba_encode.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in texts.items():
        cu, so = os.path.join(OUT, f"k6_{name}.cu"), os.path.join(OUT, f"k6_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on k6 variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in kernels._SIGNATURES.items():
            if fn.startswith("ako_manba") and hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
        if hasattr(lib, "ako_manba_chain_probe"):  # the fixed-symbol probe of older checkouts
            lib.ako_manba_chain_probe.restype = ctypes.c_int
            lib.ako_manba_chain_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                                  ctypes.c_void_p]
        lines = log.splitlines()
        regs = [" | ".join(x.split("info    :")[-1].strip() for x in lines[i : i + 4])
                for i, x in enumerate(lines) if "Compiling entry function" in x and "chain_" in x]
        print(f"k6 {name}: ptxas {regs}", flush=True)
        libs[name] = (lib, cs.cuobjdump_sass(so))
    return libs


def k6_sass(libs, lat, card) -> dict:
    """The chain loops' SASS account of each variant, written out and
    summarised; returns {variant: manba_chain_pack's account}."""
    import chip_smoke as cs

    account = {}
    os.makedirs(OUT, exist_ok=True)
    for name, (_, sass) in libs.items():
        funcs = cs.sass_functions(sass)
        keep = [k for k in funcs if "chain" in k or "op_chain" in k]
        with open(os.path.join(OUT, f"k6_sass_{name}.txt"), "w") as f:
            for k in keep:
                f.write(f"Function : {k}\n")
                f.writelines(f"  {ad:#06x}  {t:<56} {c}\n" if ad is not None else f"{t}:\n"
                             for ad, t, c in funcs[k])
        for kernel in ("manba_chain_pack", "manba_chain_alone", "manba_chain_probe"):
            if not any(kernel in k for k in funcs):
                continue
            step = cs.chain_loop_sass(sass, kernel, lat)
            if kernel == "manba_chain_pack":
                account[name] = step
            per = max(step["path_cycles_per_step"], step["insns_per_step"])
            print(f"k6 sass {name} {kernel}: loop {step['span']} of {step['steps']} steps, "
                  f"{step['insns_per_step']:.2f} instructions a step, scheduled stalls "
                  f"{step['stall_cycles_per_step']} cycles and {step['scoreboard_waits_per_step']} "
                  f"scoreboard waits a step, dependent path "
                  f"{step['path_ops_per_step']:.2f} operations / {step['path_cycles_per_step']:.2f} "
                  f"cycles a step, bound {per:.2f} cycles a step; path {' '.join(step['path'])} "
                  f"[{card}]", flush=True)
    return account


def k6_op_chains(lib, sass, card) -> dict:
    """The operations' latencies, and each chain's loop in SASS (the ops
    on its dependent path a loop, to check that each is the one named)."""
    import chip_smoke as cs

    lat = cs.op_latencies(lib)
    unit = {k: 1.0 for k in cs.OP_CHAINS}
    for k, name in enumerate(cs.OP_CHAINS):
        funcs = [v for f, v in cs.sass_functions(sass).items() if f"manba_op_chainILi{k}E" in f]
        loops = [lp for f in funcs for lp in cs.sass_loops(f)]
        desc = []
        for a, b, body in loops:
            _, path = cs.dependent_path([t for t, _ in body], unit)
            ops = {o: path.count(o) for o in sorted(set(path))}
            desc.append(f"{len(body)} instructions, path {ops}")
        print(f"k6 op {name}: {lat[name]:.3f} cycles an operation; SASS loops {desc} [{card}]",
              flush=True)
    return lat


def k6(other, card: str) -> None:
    import threading

    import numpy as np
    import torch

    import ako_tpu_torch as P
    import chip_smoke as cs
    from ako_tpu_torch.ops import manba_device as md
    from ako_tpu_torch.runtime.kagari import manba_encode
    from ako_tpu_torch.utils.corpus import corpus

    libs = _k6_sources(other)
    lat = k6_op_chains(libs["new"][0], libs["new"][1], card)
    account = k6_sass(libs, lat, card)
    dev = torch.device("cuda:0")
    img = corpus(42, 1, 1280, 1024, 4)[0]
    cur = torch.cuda.current_stream().cuda_stream
    settings = {}
    for name in ("north_t128", "default_whole"):
        ((streams, cap, _),) = cs.group_streams(dev, img, cs.north_star_settings(P)[name])
        values = streams.cpu().numpy()
        native = [manba_encode(v, cap) for v in values]
        plain = cs.k6e_used(*md.manba_encode_plain(streams, cap), cap) if name == "north_t128" else None
        settings[name] = (streams, cap, native, plain)
    rows = {}
    for name in list(libs) + list(libs)[::-1]:
        lib = libs[name][0]
        row = rows.setdefault(name, [])
        res = {}
        if hasattr(lib, "ako_manba_chain_alone"):
            streams, cap, _, _ = settings["north_t128"]
            rec = torch.empty((1, md.RECORD_WORDS), dtype=torch.int32, device=dev)
            rans = torch.empty((1, cap), dtype=torch.uint8, device=dev)
            extras = torch.empty((1, 4 * -(-cap // 4)), dtype=torch.uint8, device=dev)
            scratch = torch.empty((-(-streams.shape[1] // md.K6_CHUNK) * md.K6_SCRATCH,),
                                  dtype=torch.int32, device=dev)
            if lib.ako_manba_encode(streams.data_ptr(), rec.data_ptr(), scratch.data_ptr(),
                                    rans.data_ptr(), extras.data_ptr(), 1, streams.shape[1], cap,
                                    -(-cap // 4), cur):
                raise RuntimeError(f"k6 {name}: ako_manba_encode failed")
            a = cs.chain_alone(lib, streams[0].contiguous(), rec[0])
            res["alone"] = (round(a["cycles_per_step"], 3), round(a["ns_per_step"], 4),
                            round(a["ghz"], 4))
        elif hasattr(lib, "ako_manba_chain_probe"):
            probe = torch.zeros(2, dtype=torch.int32, device=dev)
            ms = cs._event_ms(lambda: lib.ako_manba_chain_probe(probe.data_ptr(), 65560, 1365, cur),
                              iters=5)
            res["fixed_symbol_probe_ns"] = round(ms * 1e6 / 65560, 4)
        for setting, (streams, cap, native, plain) in settings.items():
            rows_, n = streams.shape
            row_words = -(-cap // 4)
            rec = torch.empty((rows_, md.RECORD_WORDS), dtype=torch.int32, device=dev)
            rans = torch.empty((rows_, cap), dtype=torch.uint8, device=dev)
            extras = torch.empty((rows_, 4 * row_words), dtype=torch.uint8, device=dev)
            scratch = torch.empty((rows_ * -(-n // md.K6_CHUNK) * md.K6_SCRATCH,),
                                  dtype=torch.int32, device=dev)
            args = (streams.data_ptr(), rec.data_ptr(), scratch.data_ptr(), rans.data_ptr(),
                    extras.data_ptr(), rows_, n, cap, row_words, cur)

            def call(fn):
                def run():
                    rc = fn(*args)
                    if rc:
                        raise RuntimeError(f"k6 {name}: cudaError {rc}")
                return run

            full = call(lib.ako_manba_encode)
            full()
            torch.cuda.synchronize()
            got = cs.k6e_used(rec, rans, extras[:, :cap], cap)
            if plain is not None and (not np.array_equal(got[0], plain[0]) or got[1] != plain[1]):
                raise AssertionError(f"k6 variant {name} != plain on {setting}")
            if cs.manba_payloads(rec, rans, extras[:, :cap], cap) != native:
                raise AssertionError(f"k6 variant {name}: payloads differ from the native coder "
                                     f"on {setting}")
            iters = 20 if setting == "north_t128" else 5
            r = {"chain_pack": round(cs._launch_ms(full, "manba_chain_pack", iters), 4),
                 "stats": round(cs._launch_ms(full, "manba_stats", iters), 4),
                 "model": round(cs._launch_ms(full, "manba_model", iters), 4),
                 "events": round(cs._event_ms(full, iters=5), 4)}
            if hasattr(lib, "ako_manba_encode_chains"):
                r["chains_only"] = round(cs._launch_ms(call(lib.ako_manba_encode_chains),
                                                       "manba_chain_pack", iters), 4)
            r["in_situ_ns"] = round(r["chain_pack"] * 1e6 / n, 4)
            res[setting] = r
        row.append(res)
        print(f"k6 {name}: {res} [{card}]", flush=True)
    # the SM clock while the whole tile's encodes run
    streams, cap, _, _ = settings["default_whole"]
    done = threading.Event()

    def busy():
        while not done.is_set():
            md.manba_encode_device(streams, cap)
            torch.cuda.synchronize()

    th = threading.Thread(target=busy)
    th.start()
    try:
        time.sleep(1.0)
        clocks = [subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                                  "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
                  for _ in range(3)]
    finally:
        done.set()
        th.join()
    print(f"k6 nvidia-smi during the whole tile's encodes (clocks.sm, clocks.max.sm, power.draw): "
          f"{clocks} [{card}]", flush=True)
    for name, res in rows.items():
        print(f"k6 summary {name}: {json.dumps(res)} [{card}]", flush=True)
    # the latency bound of each variant: the longer of its chain loop's
    # dependent path and its instructions a step, at the SM clock the
    # new kernel's chain alone read
    ghz = rows["new"][0]["alone"][2]
    for name, step in account.items():
        ns = max(step["path_cycles_per_step"], step["insns_per_step"]) / ghz
        print(f"k6 bound {name}: {step['path_ops_per_step']:.2f} dependent operations / "
              f"{step['path_cycles_per_step']:.2f} cycles and {step['insns_per_step']:.2f} "
              f"instructions a step (schedule {step['stall_cycles_per_step']:.2f} cycles) -> "
              f"{ns:.3f} ns a step at {ghz:.4f} GHz: north star "
              f"{ns * settings['north_t128'][0].shape[1] / 1e6:.4f} ms, whole tile "
              f"{ns * settings['default_whole'][0].shape[1] / 1e6:.3f} ms [{card}]", flush=True)


SPLIT_CHILD = r'''
import hashlib, json, os, sys
sys.path.insert(0, sys.argv[1])
os.environ["AKO_TORCH_LIFT_MODE"] = "split"
import numpy as np
import torch
import chip_smoke as cs
import ako_tpu_torch as P
from ako_tpu_torch.decode import stream_pixels
from ako_tpu_torch.encode import checked_settings, forward_streams
from ako_tpu_torch.utils.corpus import corpus

assert os.path.dirname(P.__file__).startswith(sys.argv[1]), P.__file__
dev = torch.device("cuda:0")
img = corpus(42, 1, 1280, 1024, 4)[0]
north = P.Settings(quantization=16, tiles_dimension=128)
s = checked_settings(north)
tiles = torch.from_numpy(np.stack([img[y : y + 128, x : x + 128] for y in range(0, 1280, 128)
                                   for x in range(0, 1024, 128)])).to(dev)
streams = forward_streams(tiles, 128, 128, 4, s)
pixels = stream_pixels(streams, 128, 128, 4, s)
out = {"streams": hashlib.sha256(streams.cpu().numpy().tobytes()).hexdigest()[:16],
       "pixels": hashlib.sha256(pixels.cpu().numpy().tobytes()).hexdigest()[:16]}
blob = P.encode(img, north, device=dev, device_entropy=True)
for name, fn in (("forward_streams", lambda: forward_streams(tiles, 128, 128, 4, s)),
                 ("stream_pixels", lambda: stream_pixels(streams, 128, 128, 4, s)),
                 ("encode", lambda: P.encode(img, north, device=dev, device_entropy=True)),
                 ("decode", lambda: P.decode(blob, device=dev, device_entropy=True))):
    r = cs._profile_window(fn)
    out[name] = {"busy": round(r["busy"], 4), "wall": round(r["wall"], 3), "kernels": r["kernels"],
                 "copies": r["copies"], "ops": r["ops"],
                 "per": {k: round(v, 4) for k, v in sorted(r["per"].items())}}
    if name in ("forward_streams", "stream_pixels"):
        out[name]["enqueue"] = round(cs._enqueue_ms(fn), 3)
        out[name]["span"] = round(cs._span_ms(fn), 4)
print("RESULT " + json.dumps(out), flush=True)
'''


#: variant name -> ((old, new) source edits of csrc/vlift.cu, whether it
#: still computes the function): runs a CTA (8 as it is: 256 threads at
#: most; 4, 2); and, to show where a launch's time goes, the tiles' loads
#: and stores without the lift (mem_only), each CTA's index arithmetic
#: alone (setup_only), and up to the tile's load and its barrier
#: (load_only)
_RUNS = "constexpr int kMaxRuns = 8;"
VLIFT_VARIANTS = {
    "runs8": ([], True),
    "runs4": ([(_RUNS, "constexpr int kMaxRuns = 4;")], True),
    "runs2": ([(_RUNS, "constexpr int kMaxRuns = 2;")], True),
    "mem_only": ([("    int h[kRun + 3];  // high-pass values of pairs a - 2 .. a + kRun\n",
                   "    for (int j = 0; j < kRun; ++j) { lp[j] = ev[j + 3]; hp[j] = od[j + 3]; }\n"
                   "    return;\n    int h[kRun + 3];\n"),
                  ("    int e[kRun + 3];  // even samples of pairs a - 1 .. a + kRun + 1\n",
                   "    for (int j = 0; j < kRun; ++j) { ev[j] = lo[j + 3]; od[j] = hi[j + 3]; }\n"
                   "    return;\n    int e[kRun + 3];\n"),
                  ("__device__ void lift_edge(EV ev, OD od, int a, int n, Scratch s, int* lp, int* hp) {\n",
                   "__device__ void lift_edge(EV ev, OD od, int a, int n, Scratch s, int* lp, int* hp) {\n"
                   "    for (int j = 0; j < kRun; ++j) { lp[j] = ev(a + j); hp[j] = od(a + j); }\n"
                   "    if (n > 0) return;\n"),
                  ("__device__ void unlift_edge(LO lo, HI hi, int a, int n, Scratch s, int* ev, int* od) {\n",
                   "__device__ void unlift_edge(LO lo, HI hi, int a, int n, Scratch s, int* ev, int* od) {\n"
                   "    for (int j = 0; j < kRun; ++j) { ev[j] = lo(a + j); od[j] = hi(a + j); }\n"
                   "    if (n > 0) return;\n")],
                 False),
    "setup_only": ([("    int ev[kWin], od[kWin], lp[kRun], hp[kRun];\n",
                     "    if (a.n > 0) return;\n    int ev[kWin], od[kWin], lp[kRun], hp[kRun];\n"),
                    ("    int lo[kWin], hi[kWin], ev[kRun], od[kRun];\n",
                     "    if (a.n > 0) return;\n    int lo[kWin], hi[kWin], ev[kRun], od[kRun];\n")],
                   False),
    "load_only": ([("        cp_async_wait<0>();\n        __syncthreads();\n",
                    "        cp_async_wait<0>();\n        __syncthreads();\n        if (a.n > 0) return;\n")],
                  False),
}


def _vlift_sources():
    """{variant: ctypes library}: VLIFT_VARIANTS of csrc/vlift.cu built side
    by side; each one's SASS written to build/probe/vlift_sass_<name>.txt."""
    import chip_smoke as cs
    from ako_tpu_torch.runtime import kernels

    csrc = os.path.join(ROOT, "ako_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "vlift.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (edits, _) in VLIFT_VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"vlift variant {name}: the source has no {old!r}")
            text = text.replace(old, new)
        cu, so = os.path.join(OUT, f"vlift_{name}.cu"), os.path.join(OUT, f"vlift_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", csrc, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the vlift variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn in ("ako_vlift", "ako_vunlift"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        print(f"split variant {name}: ptxas max registers {max(regs, default=0)}, spill stores "
              f"{spills} B", flush=True)
        with open(os.path.join(OUT, f"vlift_sass_{name}.txt"), "w") as f:
            f.write(cs.cuobjdump_sass(so))
        libs[name] = lib
    return libs


def _split_level(lib, wav, wrap, x, quads, lvl):
    """The split wiring's level through `lib`'s ako_vlift / ako_vunlift
    (the pass along -1, then both halves along -2 in one launch): (forward,
    inverse) callables, each returning its outputs."""
    import torch

    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.runtime import kernels

    n, h, w = x.shape
    th, tw = lvl.target_h, lvl.target_w
    cur = torch.cuda.current_stream().cuda_stream

    def call(fn, args, ins, outs):
        rc = fn(ctypes.byref(args), ctypes.byref(kernels._ptrs([t.data_ptr() for t in ins],
                                                               [t.data_ptr() for t in outs])), cur)
        if rc:
            raise RuntimeError(f"vlift variant: cudaError {rc}")

    def new(*shape):
        return torch.empty(shape, dtype=torch.int16, device=x.device)

    def fwd():
        lp, hp = new(n, h, tw), new(n, h, tw)
        call(lib.ako_vlift, lk._vlift_args(n, h, w, -1, wav, wrap, 1), [x], [lp, hp])
        ll, c, b, d = (new(n, th, tw) for _ in range(4))
        call(lib.ako_vlift, lk._vlift_args(n, h, tw, -2, wav, wrap, 2), [lp, hp], [ll, c, b, d])
        return ll, b, c, d

    def inv():
        ll, b, c, d = quads
        left, right = new(n, h, tw), new(n, h, tw)
        call(lib.ako_vunlift, lk._vlift_args(n, h, tw, -2, wav, wrap, 2), [ll, c, b, d],
             [left, right])
        out = new(n, h, w)
        call(lib.ako_vunlift, lk._vlift_args(n, h, w, -1, wav, wrap, 1), [left, right], [out])
        return out

    return fwd, inv


def _split_other(other):
    """OTHER's csrc/lift2d.cu built alone, with its ako_vlift / ako_vunlift
    bound as its kernels.py bound them (one call a launch, along -2)."""
    from ako_tpu_torch.runtime import kernels

    csrc = os.path.join(other, "ako_tpu_torch", "csrc")
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "split_other.so")
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", csrc, "-shared", "-o", so,
                          os.path.join(csrc, "lift2d.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on OTHER's lift2d.cu:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(so)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ako_vlift.restype = lib.ako_vunlift.restype = I
    lib.ako_vlift.argtypes = [P] * 3 + [LL, I, I, I, I, P]
    lib.ako_vunlift.argtypes = [P] * 3 + [LL, I, I, I, I, I, P]
    return lib


def _device_ms(fn, iters: int = 20) -> dict:
    """A call's device ms by kernel of chip_smoke's table (others under
    "other"), its busy ms (the union of its device intervals) and its
    device events, over `iters` calls under torch.profiler. The profiler
    may drop a few events of short kernels: each kernel (by its full name)
    counts its mean event time times its events a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    by_name: dict = {}
    busy, end = 0.0, float("-inf")
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name.setdefault(name, []).append(b - a)
    out = {"events": 0.0, "busy": busy / 1e3 / iters}
    for name, times in by_name.items():
        m = cs.KERNEL_RE.search(name)
        key = m.group(1) if m else "other"
        per_call = max(1, round(len(times) / iters))
        out[key] = out.get(key, 0.0) + sum(times) / len(times) * per_call / 1e3
        out["events"] += per_call
    return out


def split_variants(dev, card: str) -> None:
    """VLIFT_VARIANTS in turns on the north star's split levels: device ms
    a level of the two K1v (K2v) launches, each variant checked against
    the plain version."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.core.settings import Wavelet, Wrap
    from ako_tpu_torch.ops import wavelets

    libs = _vlift_sources()
    n, wrap = 320, Wrap.CLAMP
    rng = np.random.default_rng(11)
    sums: dict = {}
    for k, lvl in enumerate(geometry.lift_schedule(128, 128).levels):
        wav = wavelets.effective_wavelet(Wavelet.DD137, lvl.target_w, lvl.target_h)
        x = cs._rand16(rng, (n, lvl.current_h, lvl.current_w), dev)
        quads = [cs._rand16(rng, (n, lvl.target_h, lvl.target_w), dev) for _ in range(4)]
        want_fwd = wavelets.lift2d(wav, wrap, x, lvl)
        want_inv = wavelets.unlift2d(wav, wrap, *quads, lvl)
        rows: dict = {}
        for name in list(libs) + list(libs)[::-1]:
            fwd, inv = _split_level(libs[name], wav, wrap, x, quads, lvl)
            got_fwd, got_inv = fwd(), inv()
            if VLIFT_VARIANTS[name][1] and not (
                    all(torch.equal(g, r) for g, r in zip(got_fwd, want_fwd))
                    and torch.equal(got_inv, want_inv)):
                raise AssertionError(f"split variant {name} level {k} != plain")
            f, i = _device_ms(fwd), _device_ms(inv)
            rows.setdefault(name, []).append((f.get("vlift", 0), i.get("vunlift", 0)))
        for name, runs in rows.items():
            acc = sums.setdefault(name, [0.0, 0.0])
            acc[0] += min(r[0] for r in runs)
            acc[1] += min(r[1] for r in runs)
        # the yardstick of the bytes: a torch copy of the level's plane
        # (read once, written once) and of its halves, as many bytes as
        # each launch pair moves
        copy = _device_ms(lambda: x.clone())["busy"]
        print(f"split variants level {k} {lvl.current_h}x{lvl.current_w}: torch clone of x "
              f"{copy:.4f} ms; " + ", ".join(
            f"{name} K1v {' / '.join(f'{a:.4f}' for a, _ in runs)} K2v "
            f"{' / '.join(f'{b:.4f}' for _, b in runs)}" for name, runs in rows.items())
            + f" ms [{card}]", flush=True)
    for name, (a, b) in sums.items():
        print(f"split variants sum {name}: K1v {a:.4f} ms, K2v {b:.4f} ms (the lesser of two "
              f"turns a level) [{card}]", flush=True)


def split(other, card: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.core.settings import Wavelet, Wrap
    from ako_tpu_torch.ops import lift_kernels as lk
    from ako_tpu_torch.ops import wavelets

    old = _split_other(other) if other else None
    dev = torch.device("cuda:0")
    cur = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(9)
    n, wrap = 320, Wrap.CLAMP

    def check(rc, name):
        if rc:
            raise RuntimeError(f"{name}: cudaError {rc}")

    def t(x):
        return x.transpose(-1, -2).contiguous()

    totals: dict = {}
    for k, lvl in enumerate(geometry.lift_schedule(128, 128).levels):
        wav = wavelets.effective_wavelet(Wavelet.DD137, lvl.target_w, lvl.target_h)
        h, w, th, tw = lvl.current_h, lvl.current_w, lvl.target_h, lvl.target_w
        x = cs._rand16(rng, (n, h, w), dev)
        quads = [cs._rand16(rng, (n, th, tw), dev) for _ in range(4)]

        def this_fwd():
            return lk.lift2d_level(wav, wrap, x, lvl, "split")

        def this_inv():
            return lk.unlift2d_level(wav, wrap, *quads, lvl, "split")

        def this3_fwd():
            lp, hp = lk.vlift_level(wav, wrap, x, -1)
            (ll, c), (b, d) = lk.vlift_level(wav, wrap, lp), lk.vlift_level(wav, wrap, hp)
            return ll, b, c, d

        def this3_inv():
            ll, b, c, d = quads
            left, right = lk.vunlift_level(wav, wrap, ll, c, h), lk.vunlift_level(wav, wrap, b, d, h)
            return lk.vunlift_level(wav, wrap, left, right, w, -1)

        def other_fwd():
            xt = t(x)
            lp_t, hp_t = (torch.empty((n, tw, h), dtype=torch.int16, device=dev) for _ in range(2))
            check(old.ako_vlift(xt.data_ptr(), lp_t.data_ptr(), hp_t.data_ptr(), n, w, h, wav, wrap,
                                cur), "other vlift")
            outs = []
            for half in (t(lp_t), t(hp_t)):
                a, b = (torch.empty((n, th, tw), dtype=torch.int16, device=dev) for _ in range(2))
                check(old.ako_vlift(half.data_ptr(), a.data_ptr(), b.data_ptr(), n, h, tw, wav, wrap,
                                    cur), "other vlift")
                outs.append((a, b))
            (ll, c), (b, d) = outs
            return ll, b, c, d

        def other_inv():
            ll, b, c, d = quads
            halves = []
            for lo, hi in ((ll, c), (b, d)):
                o = torch.empty((n, h, tw), dtype=torch.int16, device=dev)
                check(old.ako_vunlift(lo.data_ptr(), hi.data_ptr(), o.data_ptr(), n, th, tw, h, wav,
                                      wrap, cur), "other vunlift")
                halves.append(t(o))
            o = torch.empty((n, w, h), dtype=torch.int16, device=dev)
            check(old.ako_vunlift(halves[0].data_ptr(), halves[1].data_ptr(), o.data_ptr(), n, tw, h,
                                  w, wav, wrap, cur), "other vunlift")
            return t(o)

        want_fwd = wavelets.lift2d(wav, wrap, x, lvl)
        want_inv = wavelets.unlift2d(wav, wrap, *quads, lvl)
        variants = {"this": (this_fwd, this_inv), "this_3": (this3_fwd, this3_inv)}
        if old:
            variants["other"] = (other_fwd, other_inv)
        for name, (fwd, inv) in variants.items():
            got = fwd()
            if not (all(torch.equal(g, r) for g, r in zip(got, want_fwd))
                    and torch.equal(inv(), want_inv)):
                raise AssertionError(f"split {name} level {k} != plain")
        # this wiring's two launches a level apart: the pass along -1 (h) and
        # both halves along -2 in one launch (v)
        lp, hp = lk.vlift_level(wav, wrap, x, -1)
        ll, b, c, d = quads
        left, right = lk.vunlift_pair(wav, wrap, (ll, c), (b, d), h)
        parts = {"K1v h": lambda: lk.vlift_level(wav, wrap, x, -1),
                 "K1v v": lambda: lk.vlift_pair(wav, wrap, lp, hp),
                 "K2v v": lambda: lk.vunlift_pair(wav, wrap, (ll, c), (b, d), h),
                 "K2v h": lambda: lk.vunlift_level(wav, wrap, left, right, w, -1)}
        print(f"split level {k} {h}x{w} launches: " + ", ".join(
            f"{name} {sum(v for key, v in _device_ms(fn).items() if key in ('vlift', 'vunlift')):.4f}"
            for name, fn in parts.items()) + f" ms [{card}]", flush=True)
        order = ["other", "this", "this_3", "this_3", "this", "other"]
        rows: dict = {}
        for name in (v for v in order if v in variants):
            fwd, inv = variants[name]
            rows.setdefault(name, []).append((_device_ms(fwd), _device_ms(inv)))
        for name, runs in rows.items():
            fmt = [f"K1v {f.get('vlift', 0):.4f} ms (busy {f['busy']:.4f}, {f['events']:.0f} device "
                   f"kernels), K2v {i.get('vunlift', 0):.4f} ms (busy {i['busy']:.4f}, "
                   f"{i['events']:.0f})" for f, i in runs]
            sums = totals.setdefault(name, [[0.0] * 4 for _ in runs])
            for j, (f, i) in enumerate(runs):
                for m, v in enumerate((f.get("vlift", 0), f["busy"], i.get("vunlift", 0), i["busy"])):
                    sums[j][m] += v
            print(f"split level {k} {h}x{w} {wav.name} n={n} {name}: {' | '.join(fmt)} [{card}]",
                  flush=True)
    for name, runs in totals.items():
        print(f"split sum over levels {name}: " + " | ".join(
            f"K1v {a:.4f} ms (busy {b:.4f}), K2v {c:.4f} ms (busy {d:.4f})" for a, b, c, d in runs)
            + f" [{card}]", flush=True)
    print(f"split launch floor: an empty kernel {cs.launch_floor_ms(dev):.5f} ms (median of 50) "
          f"[{card}]", flush=True)
    split_variants(dev, card)
    roots = [("other", os.path.realpath(other)), ("this", ROOT), ("this", ROOT),
             ("other", os.path.realpath(other))] if other else [("this", ROOT), ("this", ROOT)]
    digests = set()
    for name, root in roots:
        res = subprocess.run([sys.executable, "-c", SPLIT_CHILD, root], capture_output=True,
                             text=True, cwd=root, timeout=600)
        line = [x for x in res.stdout.splitlines() if x.startswith("RESULT ")]
        if res.returncode or not line:
            raise RuntimeError(f"split {name} failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        r = json.loads(line[0][len("RESULT "):])
        digests.add((r.pop("streams"), r.pop("pixels")))
        print(f"split streams {name}: {json.dumps(r)} [{card}]", flush=True)
    if len(digests) != 1:
        raise AssertionError(f"split: the checkouts' streams or pixels differ: {digests}")


# ---------------------------------------------------------------- k6d

K6D_TABLE = "    __syncthreads();\n"
K6D_END = "    }\n}\n\n// CTAs a tile"
K6D_KERNEL = "__global__ void __launch_bounds__(kMaxWarps * 32)\nmanba_decode("
K6D_CLOCK_EXPORT = """
// per CTA: clock64 at its start, after its table and at its end (twice:
// its chains hold its stores), then globaltimer at its start and end
// (chip_probe.py k6d); with host null, every row set to 0
extern "C" int ako_k6d_clocks(unsigned long long* host, int ctas) {
    if (host == nullptr) {
        void* rows = nullptr;
        cudaError_t rc = cudaGetSymbolAddress(&rows, k6d_clock);
        return (int)(rc != cudaSuccess ? rc : cudaMemset(rows, 0, sizeof(k6d_clock)));
    }
    return (int)cudaMemcpyFromSymbol(host, k6d_clock, sizeof(unsigned long long) * 6 *
                                                          (size_t)(ctas < 8192 ? ctas : 8192));
}
"""


K6D_WINDOWS = "    int rbits = 8 * (int)max(min(rleft, 1LL << 24), -1LL);\n"
K6D_PREFETCH = """    {
        const uint32_t rb1 = lane + 1 < blocks ? rbyte[rec + 1] : rend;
        const uint32_t eb1 = lane + 1 < blocks ? ebit[rec + 1] : eb + 2048;
        for (uint32_t w = b + rb / 4; w <= min(b + rb1 / 4 + 4, pool_words - 1); w += 8)
            asm volatile("prefetch.global.L1 [%0];" :: "l"(pool + w));
        const unsigned long long e1 = (unsigned long long)eoff * 8 + eb1;
        for (uint32_t w = b + (uint32_t)(ebits >> 5);
             w <= min(b + (uint32_t)(e1 >> 5) + 4, pool_words - 1); w += 8)
            asm volatile("prefetch.global.L1 [%0];" :: "l"(pool + w));
    }
"""
K6D_SINK = "    }\n    if (sink == 0x7FFFFFFFu) out[0] = (int16_t)sink;\n}\n\n// CTAs a tile"


def _k6d_exit(value: str) -> str:
    return (K6D_TABLE + "    if (lane < wb * 32 && lane < blocks) out[(size_t)tile * n + "
            f"(size_t)lane * kBlock] = (int16_t)table[({value}) & (kSlots - 1)];\n    return;\n")


#: K6d as this checkout writes it (csrc/manba_decode.cu), in variants:
#: variant -> (source edits, whether it computes the function).
#: setup: the records and frequencies loaded and the table built (the
#: windows' loads, unused, left out by the compiler), then one store a
#: lane; windows: also both windows started; chain: every step, the
#: outputs summed instead of stored; whole: as it is; no_guard: the
#: refills without the payload's end (exact on these streams); no_loads:
#: the windows' words after their first four made up instead of loaded;
#: no_lds: the table's entry made up from the state instead of loaded;
#: no_conflict: the table read at x & 31 (no bank conflict); ca_loads: the
#: windows' loads through ld.global.ca; prefetch: each lane's spans
#: prefetched into L1 at its start; clocked: as it is, with clock64 and
#: globaltimer read by each CTA's thread 0 (ako_k6d_clocks).
K6D_NEW = {
    "setup": ([(K6D_TABLE, _k6d_exit("x ^ rb ^ eb ^ b ^ rend ^ eoff"))], False),
    "windows": ([(K6D_TABLE, _k6d_exit("x ^ r.w0 ^ r.w1 ^ r.n1 ^ r.n2 ^ e.w0 ^ e.w1 ^ e.n1 ^ "
                                       "e.n2 ^ (uint32_t)rbits"))], False),
    "chain": ([("    char* buf = reinterpret_cast<char*>(buffers)",
                "    uint32_t sink = 0;\n    char* buf = reinterpret_cast<char*>(buffers)"),
               ("            if (vec) {\n                uint4* row",
                "            for (int j = 0; j < kGroup; ++j) sink += v[j];\n"
                "            if (vec && n < 0) {\n                uint4* row"),
               ("            } else {\n#pragma unroll\n                for (int j = 0; j < kGroup; ++j)",
                "            } else if (n < 0) {\n#pragma unroll\n"
                "                for (int j = 0; j < kGroup; ++j)"),
               (K6D_END, K6D_SINK)], False),
    "whole": ([], True),
    "no_guard": ([("const bool n0 = x < kStateLo && rbits >= 8;", "const bool n0 = x < kStateLo;"),
                  ("const bool n1 = x < (kStateLo >> 8) && rbits >= 16;",
                   "const bool n1 = x < (kStateLo >> 8);")], True),
    "no_loads": ([("if (m) n2 = __ldg(pool + min(j + first3, last));", "if (m) n2 = w1 ^ j;")],
                 False),
    "no_lds": ([("const uint32_t t = table[x & (kSlots - 1)];",
                 "const uint32_t t = (x & 0xFFF00FFFu) | 0x1000u;")], False),
    "no_conflict": ([("const uint32_t t = table[x & (kSlots - 1)];",
                      "const uint32_t t = table[x & 31];")], False),
    "ca_loads": ([("if (m) n2 = __ldg(pool + min(j + first3, last));",
                   "if (m) asm(\"ld.global.ca.u32 %0, [%1];\" : \"=r\"(n2) : "
                   "\"l\"(pool + min(j + first3, last)));")], True),
    "prefetch": ([(K6D_WINDOWS, K6D_WINDOWS + K6D_PREFETCH)], True),
    "clocked": ([
        (K6D_KERNEL, "__device__ unsigned long long k6d_clock[6 * 8192];\n\n" + K6D_KERNEL),
        ("    extern __shared__ uint4 buffers[];  // a buffer a warp\n",
         "    extern __shared__ uint4 buffers[];  // a buffer a warp\n"
         "    unsigned long long k6d_c0 = 0, k6d_c1 = 0, k6d_g0 = 0;\n"
         "    if (threadIdx.x == 0) {\n"
         "        asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(k6d_g0));\n"
         "        k6d_c0 = clock64();\n    }\n"),
        (K6D_TABLE, K6D_TABLE + "    if (threadIdx.x == 0) k6d_c1 = clock64();\n"),
        (K6D_END, "    }\n    __syncthreads();\n"
         "    if (threadIdx.x == 0 && blockIdx.x < 8192) {\n        unsigned long long g1;\n"
         "        const unsigned long long c2 = clock64();\n"
         "        asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
         "        unsigned long long* c = k6d_clock + 6 * blockIdx.x;\n"
         "        c[0] = k6d_c0; c[1] = k6d_c1; c[2] = c2; c[3] = c2; c[4] = k6d_g0; c[5] = g1;\n"
         "    }\n}\n\n// CTAs a tile"),
        ("}  // namespace\n", "}  // namespace\n" + K6D_CLOCK_EXPORT),
    ], True),
}


def _k6d_sources(roots: dict) -> dict:
    """{(checkout, variant): (ctypes library, SASS text, exact)}: the
    variants of each checkout's csrc/manba_decode.cu built side by side
    (the ones whose anchors its source holds)."""
    import chip_smoke as cs
    from ako_tpu_torch.runtime import kernels

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for who, root in roots.items():
        src = open(os.path.join(root, "ako_tpu_torch", "csrc", "manba_decode.cu")).read()
        design = K6D_NEW if who == "this" else {"whole": ([], True)}  # OTHER's: as it is
        for name, (edits, exact) in design.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"k6d {who} variant {name}: the source has no {old!r}")
                text = text.replace(old, new)
            cu, so = (os.path.join(OUT, f"k6d_{who}_{name}.{ext}") for ext in ("cu", "so"))
            with open(cu, "w") as f:
                f.write(text)
            procs[(who, name)] = (subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so, exact)
    libs = {}
    for key, (proc, so, exact) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on k6d variant {key}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.ako_manba_decode.restype = ctypes.c_int
        lib.ako_manba_decode.argtypes = kernels._SIGNATURES["ako_manba_decode"]
        if hasattr(lib, "ako_k6d_clocks"):
            lib.ako_k6d_clocks.restype = ctypes.c_int
            lib.ako_k6d_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lines = log.splitlines()
        regs = [" | ".join(x.split("info    :")[-1].strip() for x in lines[i : i + 4])
                for i, x in enumerate(lines) if "Compiling entry function" in x
                and "manba_decode" in x]
        print(f"k6d {key[0]} {key[1]}: ptxas {regs}", flush=True)
        libs[key] = (lib, cs.cuobjdump_sass(so), exact)
    return libs


def _k6d_clock_split(lib, args, ctas: int) -> dict:
    """One launch of the clocked variant: per CTA its cycles to the end
    of its table and of its chains with their stores (clock64), and its
    cycles over its nanoseconds (globaltimer); the median and the largest
    of each."""
    import numpy as np
    import torch

    rc = lib.ako_k6d_clocks(None, 0) or lib.ako_manba_decode(*args)
    torch.cuda.synchronize()
    host = np.zeros((min(ctas, 8192), 6), np.uint64)
    rc = rc or lib.ako_k6d_clocks(host.ctypes.data, host.shape[0])
    c = host.astype(np.float64)
    if rc:
        raise RuntimeError(f"k6d clocked: cudaError {rc}")
    c = c[c[:, 5] > 0]  # the rows this launch wrote
    cta = c[:, 3] - c[:, 0]
    parts = {"setup": c[:, 1] - c[:, 0], "chain": c[:, 2] - c[:, 1], "stores": c[:, 3] - c[:, 2],
             "cta": cta, "ghz": cta / np.maximum(c[:, 5] - c[:, 4], 1)}
    span_us = (c[:, 5].max() - c[:, 4].min()) / 1e3
    out = {k: (round(float(np.median(v)), 3), round(float(v.max()), 3)) for k, v in parts.items()}
    out["span_us"] = round(float(span_us), 3)
    out["ctas"] = len(c)
    return out


K6D_CHILD = r"""
import json, os, statistics, sys
os.environ["TEARDOWN_CUPTI"] = "1"
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as cs
import ako_tpu_torch as P
from ako_tpu_torch.ops import manba_device as md
from ako_tpu_torch.runtime.kagari import manba_encode
from ako_tpu_torch.utils.corpus import corpus

assert os.path.dirname(P.__file__).startswith(sys.argv[1]), P.__file__
dev = torch.device("cuda:0")
img = corpus(42, 1, 1280, 1024, 4)[0]
out = {}
for name in ("north_t128", "default_whole"):
    ((streams, cap, _),) = cs.group_streams(dev, img, cs.north_star_settings(P)[name])
    values = streams.cpu().numpy()
    parts, _ = cs.manba_decode_inputs([manba_encode(v, cap) for v in values], values.shape[1], dev)
    dec = lambda: md.manba_decode_device(*parts, values.shape[1])
    if not np.array_equal(dec().cpu().numpy(), values):
        raise AssertionError(f"K6d of {sys.argv[1]} differs from the streams on {name}")
    out[name] = {"profiler_ms": [round(cs._launch_ms(dec, "manba_decode"), 5) for _ in range(2)],
                 "events_ms": round(cs._event_ms(dec), 5)}
s = cs.manba_settings(P)["north_t128_manba"]
with cs.manba_env(True):
    blob = P.encode(img, s, device=dev, device_entropy=True)
    dec = lambda cb=None: P.decode(blob, cb, device=dev, device_entropy=True)
    stages = [cs._stage_ms(dec) for _ in range(7)]
    out["north_t128_manba"] = {
        "decode_ms": round(cs._median_ms(dec), 3),
        "compression_ms": round(statistics.median(float(st["compression"].split()[0])
                                                  for st in stages), 3),
        "stages": stages[-1]}
print("RESULT " + json.dumps(out), flush=True)
sys.stdout.flush()
os._exit(0)
"""


def k6d(other, card: str) -> None:
    import threading

    import numpy as np
    import torch

    import ako_tpu_torch as P
    import chip_smoke as cs
    from ako_tpu_torch.runtime.kagari import manba_encode
    from ako_tpu_torch.utils.corpus import corpus

    roots = {"this": ROOT}
    if other:
        roots["other"] = os.path.realpath(other)
    libs = _k6d_sources(roots)
    lat = cs.op_latencies()
    print(f"k6d latencies (cycles): { {k: round(v, 3) for k, v in lat.items()} } [{card}]",
          flush=True)
    for (who, name), (_, sass, _) in libs.items():
        funcs = cs.sass_functions(sass)
        sass_out = os.path.join(OUT, f"k6d_sass_{who}_{name}.txt")
        with open(sass_out, "w") as f:
            for k, body in funcs.items():
                if "manba_decode" in k:
                    f.write(f"Function : {k}\n")
                    f.writelines(f"  {ad:#06x}  {t:<56} {c}\n" if ad is not None else f"{t}:\n"
                                 for ad, t, c in body)
        if name in ("setup", "windows", "clocked"):
            continue
        try:
            step = cs.decode_loop_sass(sass, cs.K6D_SASS_NAME, lat)
        except AssertionError as exc:  # a variant without the table's or the windows' loads
            print(f"k6d sass {who} {name}: {exc}", flush=True)
            continue
        print(f"k6d sass {who} {name}: loop {step['span']} of {step['steps']} steps, "
              f"{step['insns_per_step']:.2f} instructions a step, scheduled stalls "
              f"{step['stall_cycles_per_step']} cycles and {step['scoreboard_waits_per_step']} "
              f"scoreboard waits a step, dependent path {step['path_ops_per_step']:.2f} operations "
              f"/ {step['path_cycles_per_step']:.2f} cycles a step; path {' '.join(step['path'])} "
              f"[{card}]", flush=True)
    dev = torch.device("cuda:0")
    img = corpus(42, 1, 1280, 1024, 4)[0]
    cur = torch.cuda.current_stream().cuda_stream
    settings = {}
    for name in ("north_t128", "default_whole"):
        ((streams, cap, _),) = cs.group_streams(dev, img, cs.north_star_settings(P)[name])
        values = streams.cpu().numpy()
        parts, _ = cs.manba_decode_inputs([manba_encode(v, cap) for v in values], values.shape[1],
                                          dev)
        T, n = values.shape
        B = parts[4].shape[1]
        outbuf = torch.empty((T, n), dtype=torch.int16, device=dev)
        args = (parts[0].data_ptr(), parts[0].shape[0], *(t.data_ptr() for t in parts[1:]),
                outbuf.data_ptr(), T, B, n, cur)
        settings[name] = (values, outbuf, args, T * B)
    rows: dict = {}
    for key in list(libs) + list(libs)[::-1]:
        lib, _, exact = libs[key]
        res = {}
        for setting, (values, outbuf, args, lanes) in settings.items():
            def run(lib=lib, args=args):
                rc = lib.ako_manba_decode(*args)
                if rc:
                    raise RuntimeError(f"k6d {key}: cudaError {rc}")
            if key[1] == "clocked":
                res[f"{setting} clocks"] = _k6d_clock_split(lib, args, lanes)
            outbuf.zero_()
            run()
            torch.cuda.synchronize()
            if exact and not np.array_equal(outbuf.cpu().numpy(), values):
                raise AssertionError(f"k6d variant {key} differs from the streams on {setting}")
            res[setting] = round(cs._launch_ms(run, "manba_decode"), 5)
            res[f"{setting} events"] = round(cs._event_ms(run), 5)
        rows.setdefault(key, []).append(res)
        print(f"k6d {key[0]} {key[1]}: {json.dumps(res)} [{card}]", flush=True)
    # the SM clock while the whole tile's decodes run
    _, _, args, _ = settings["default_whole"]
    lib = libs[("this", "whole")][0]
    done = threading.Event()

    def busy():
        while not done.is_set():
            for _ in range(200):
                lib.ako_manba_decode(*args)
            torch.cuda.synchronize()

    th = threading.Thread(target=busy)
    th.start()
    try:
        time.sleep(1.0)
        clocks = [subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                                  "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
                  for _ in range(3)]
    finally:
        done.set()
        th.join()
    print(f"k6d nvidia-smi during the whole tile's decodes (clocks.sm, clocks.max.sm, power.draw): "
          f"{clocks} [{card}]", flush=True)
    for key, res in rows.items():
        print(f"k6d summary {key[0]} {key[1]}: {json.dumps(res)} [{card}]", flush=True)
    if not other or not os.path.exists(os.path.join(roots["other"], "chip_smoke.py")):
        return  # OTHER holds its kernel's source alone
    for who in ("other", "this", "this", "other"):
        root = roots[who]
        proc = subprocess.run([sys.executable, "-c", K6D_CHILD, root], capture_output=True,
                              text=True, cwd=root, timeout=900)
        line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
        if proc.returncode or not line:
            raise RuntimeError(f"k6d child {who} failed:\n{proc.stdout[-3000:]}\n"
                               f"{proc.stderr[-3000:]}")
        print(f"k6d checkout {who}: {line[0][len('RESULT '):]} [{card}]", flush=True)


def profiler(card: str) -> None:
    """The profiler's record of short windows as the process ages, in a
    child process a setting: CUPTI kept up across windows, as torch leaves
    it (TEARDOWN_CUPTI=0), and torn down after each window (=1, as
    chip_smoke.py sets it)."""
    for env in ({"TEARDOWN_CUPTI": "0"}, {"TEARDOWN_CUPTI": "1"}):
        print(f"profiler child, env {env}", flush=True)
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "profiler-child"],
                             env={**os.environ, **env}, timeout=600)
        if res.returncode:
            raise RuntimeError(f"profiler child {env}: exit {res.returncode}")


def profiler_child(card: str) -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import ako_tpu_torch as P
    from ako_tpu_torch.encode import checked_settings, forward_streams
    from ako_tpu_torch.ops.kagari_device import kagari_encode_device
    from ako_tpu_torch.runtime import kernels
    from ako_tpu_torch.utils.corpus import corpus

    dev = torch.device("cuda:0")
    img = corpus(42, 1, 1280, 1024, 4)[0]
    s = P.Settings(quantization=16, tiles_dimension=128)
    ((streams, cap, budget),) = cs.group_streams(dev, img, s)
    os.environ["AKO_TORCH_LIFT_MODE"] = "fused"
    cs_ = checked_settings(s)
    batch = [img[y : y + 128, x : x + 128] for y in range(0, 1280, 128) for x in range(0, 1024, 128)]
    tiles = torch.from_numpy(np.stack(batch)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    x = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    cases = {  # (call, its device events)
        "k3_alone": (lambda: kagari_encode_device(streams, cap, budget), 1),
        "forward_streams": (lambda: forward_streams(tiles, 128, 128, 4, cs_), 1),
        "empty_kernel": (lambda: kernels.launch_floor(stream), 1),
        "torch_op": (lambda: x.add_(1), 1),
    }

    def window(fn, variant) -> int:
        acts = [ProfilerActivity.CUDA] if variant == "cuda_only" else [
            ProfilerActivity.CPU, ProfilerActivity.CUDA]
        fn()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            if variant == "settle":
                time.sleep(0.002)
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)

    def tally(label):
        counts = {(c, v): [0, 0, 0] for c in cases for v in ("as_is", "settle", "cuda_only")}
        for _ in range(10):
            for (c, v), t in counts.items():
                fn, want = cases[c]
                got = window(fn, v)
                t[0 if got == 0 else 1 if got < want else 2] += 1
        for (c, v), (none, fewer, full) in counts.items():
            print(f"profiler {label} {c} {v}: of 10 windows {none} recorded no device event, "
                  f"{fewer} fewer than the call's {cases[c][1]}, {full} all [{card}]", flush=True)

    def padded(pad: float) -> dict:
        """One window around a torch op, an empty kernel and K3, padded by
        `pad` s of host sleep at each end: its device events, its host
        launch calls, and the first device event's start less the first
        cudaLaunchKernel's."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            x.add_(1)
            kernels.launch_floor(stream)
            kagari_encode_device(streams, cap, budget)
            torch.cuda.synchronize()
            time.sleep(pad)
        host = sorted((e.time_range.start, e.name) for e in prof.events()
                      if e.device_type != DeviceType.CUDA and "Launch" in e.name)
        device = sorted(e.time_range.start for e in prof.events()
                        if e.device_type == DeviceType.CUDA)
        return {"device": len(device), "launch_calls": len(host),
                "offset_us": round(device[0] - host[0][0], 1) if host and device else None}

    # a split level's calls as the host and the device record them
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.core.settings import Wavelet, Wrap
    from ako_tpu_torch.ops import lift_kernels as lk

    lvl = geometry.lift_schedule(128, 128).levels[0]
    xs = cs._rand16(np.random.default_rng(3), (320, 128, 128), dev)
    lk.lift2d_level(Wavelet.DD137, Wrap.CLAMP, xs, lvl, "split")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lk.lift2d_level(Wavelet.DD137, Wrap.CLAMP, xs, lvl, "split")
        torch.cuda.synchronize()
    print("profiler split level 0 host launch calls: " + json.dumps(
        [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
         if e.device_type != DeviceType.CUDA and e.name.startswith("cuda")]), flush=True)
    print("profiler split level 0 device events: " + json.dumps(
        [e.name[:40] for e in sorted(prof.events(), key=lambda e: e.time_range.start)
         if e.device_type == DeviceType.CUDA]), flush=True)

    tally("at start")
    # the profiler keeps only the device events that fall inside its
    # window; the host's realtime clock against its monotonic one, and
    # windows padded by 0 to 2 s, as the process ages
    t0 = time.perf_counter()
    skew0 = time.time() - time.monotonic()
    while time.perf_counter() - t0 < 100:
        row = {pad: padded(pad) for pad in (0.0, 0.05, 0.5, 2.0)}
        print(f"profiler at {time.perf_counter() - t0:.1f} s: realtime - monotonic moved "
              f"{(time.time() - time.monotonic() - skew0) * 1e3:.3f} ms; windows by pad (s): "
              f"{json.dumps(row)} [{card}]", flush=True)
        time.sleep(5)
    tally("after 100 s")


def executor(card: str, dev=None) -> None:
    import cProfile
    import importlib
    import io
    import pstats
    import statistics
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import ako_tpu_torch as P
    import chip_smoke as cs
    from ako_tpu_torch.core import container, geometry
    from ako_tpu_torch.ops.kagari_device import DECODE_BLOCK
    from ako_tpu_torch.parallel.mesh import Caller
    from ako_tpu_torch.runtime import executor as ex
    from ako_tpu_torch.runtime.kagari import kagari_sync, kagari_sync_tiles
    from ako_tpu_torch.utils.corpus import corpus

    dec_mod = importlib.import_module("ako_tpu_torch.decode")
    enc_mod = importlib.import_module("ako_tpu_torch.encode")
    dev = torch.device("cuda:0") if dev is None else dev
    cs.phase_build()
    images = corpus(42, 12, 1280, 1024, 4)
    s = enc_mod.checked_settings(P.Settings(quantization=16, tiles_dimension=128))
    blob = cs.oracle_encode(images[0], s)
    view = memoryview(blob)
    ch, w, h, _ = container.head_read(view)
    grid = geometry.tile_grid(w, h, s.tiles_dimension)

    def med(fn, runs=5):
        fn()
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    blocks, offs, cursor = [], [], container.HEAD_SIZE
    for t in grid:
        payload, cursor = dec_mod.read_tile_block(view, cursor, t, s, ch)
        blocks.append((t, payload))
        offs.append(cursor - len(payload))

    def scan(b):
        t, payload = b
        tds, spacing = dec_mod.tile_block_sizes(t, s, ch)
        return kagari_sync(tds // 2, payload, tds + spacing, DECODE_BLOCK)

    cpus = os.cpu_count() or 1
    line = {"serial": med(lambda: [scan(b) for b in blocks])}
    for n in sorted({1, 2, 4, cpus}):
        with ThreadPoolExecutor(n) as pool:
            line[f"pool {n}"] = med(lambda: list(pool.map(scan, blocks)))
    sizes = [dec_mod.tile_block_sizes(t, s, ch) for t, _ in blocks]
    for n in sorted({1, 2, 4, cpus}):
        line[f"native {n}"] = med(lambda: kagari_sync_tiles(
            view, offs, [len(p) for _, p in blocks], [b // 2 for b, _ in sizes],
            [b + sp for b, sp in sizes], DECODE_BLOCK, n))
    print(f"executor probe: one image's 80 sync scans (pool: a call a tile; native: "
          f"one call on n native threads), ms: "
          f"{ {k: round(v, 3) for k, v in line.items()} } (os.cpu_count() {cpus}) [{card}]",
          flush=True)
    items = [(t, p, sy) for (t, p), sy in zip(blocks, [scan(b) for b in blocks])]
    pix = np.zeros((len(grid), 128, 128, ch), np.uint8)
    image = np.empty((h, w, ch), np.uint8)

    def place():
        for i, t in enumerate(grid):
            image[t.y : t.y + 128, t.x : t.x + 128] = pix[i]

    slot = ex.Slot(dev)
    caller = Caller(dev)
    src, _ = caller.source(images[0])
    host = {
        "walk": med(lambda: [dec_mod.read_tile_block(view, c, t, s, ch) for t, c in
                             ex._block_offsets(view, grid, s, ch)]),
        "pack_entropy_upload": med(lambda: dec_mod.pack_entropy_upload(items)),
        "placement": med(place),
        "Shard.source": med(lambda: caller.source(images[0])),
        "stage into pinned": med(lambda: slot.buffer("x", (80, 128, 128, ch - 1), torch.uint8)
                                 .copy_(enc_mod.stage_tiles(src, grid, 128, 128))),
    }
    print(f"executor probe: host stages of one image, ms (median of 5): "
          f"{ {k: round(v, 3) for k, v in host.items()} } [{card}]", flush=True)

    for name, fn in (("encode", lambda: [P.encode(img, s, device=dev) for img in images[:3]]),
                     ("decode", lambda: [P.decode(blob, device=dev) for _ in range(3)])):
        fn()
        prof = cProfile.Profile()
        prof.enable()
        fn()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(18)
        print(f"executor probe: cProfile of 3 one-shot {name}s (main thread) [{card}]\n"
              + "\n".join(out.getvalue().splitlines()[:40]), flush=True)

    # the sequential stream with wrappers that time each stage on its thread
    acc: dict = {}
    lock = threading.Lock()

    def timed(mod, name, key=None):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                with lock:
                    acc[key or name] = acc.get(key or name, 0.0) + time.perf_counter() - t

        setattr(mod, name, wrapper)
        return mod, name, fn

    patches = [
        timed(dec_mod, "kagari_sync_tiles"), timed(dec_mod, "pack_entropy_upload"),
        timed(dec_mod, "kagari_decode_device"), timed(dec_mod, "stream_pixels"),
        timed(ex, "dispatch_tiles_device_entropy"),
        timed(ex, "dispatch_tiles_fused"), timed(ex, "collect_tiles_blocks"),
        timed(ex.Slot, "source", "Slot.source"), timed(enc_mod, "forward_streams"),
        timed(enc_mod, "kagari_encode_device"),
        timed(ex.Slot, "upload", "Slot.upload"), timed(ex.Slot, "download", "Slot.download"),
        timed(ex.Slot, "wait_dispatch", "Slot.wait_dispatch"),
        timed(ex.Slot, "synchronize", "Slot.synchronize"),
        timed(ex.PipelineDecoder, "_collect", "decoder collect"),
        timed(ex.PipelineDecoder, "_dispatch_blob", "decoder dispatch"),
    ]
    enc = ex.PipelineEncoder(s, workers=4, device=dev)
    dec = ex.PipelineDecoder(workers=4, device=dev)
    for turn in range(3):
        acc.clear()
        t = time.perf_counter()
        blobs = enc.encode_batch(images)
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        list(dec.decode_iter(blobs))
        t_dec = time.perf_counter() - t
        per = {k: round(v * 1e3 / len(images), 3) for k, v in sorted(acc.items())}
        print(f"executor probe: sequential stream, turn {turn}: encode {t_enc * 1e3 / 12:.2f}, "
              f"decode {t_dec * 1e3 / 12:.2f} ms an image (wall); stages, ms an image summed over "
              f"threads: {per} [{card}]", flush=True)
    for mod, name, fn in patches:
        setattr(mod, name, fn)

    # variants in turns: wall and the process's CPU time (every thread) a
    # stream of 12, encode and decode apart
    def torch_upload(self, key, t):
        buf = self.buffer(key, t.shape, t.dtype)
        buf.copy_(t)
        return buf.to(self.device, non_blocking=True)

    orig_upload = ex.Slot.upload
    orig_wait, orig_sync = ex.Slot.wait_dispatch, ex.Slot.synchronize

    def spin_wait(self):  # cudaStreamSynchronize: spins, by the device's default flags
        if self.stream is not None:
            self.stream.synchronize()

    spin_sync = spin_wait

    def stream(workers, threads=None, torch_copies=False, roundtrip=False, spin=False):
        old_threads = torch.get_num_threads()
        if threads:
            torch.set_num_threads(threads)
        if torch_copies:
            ex.Slot.upload = torch_upload
        if spin:  # the slots' waits spin on a core, as a plain synchronize() does
            ex.Slot.wait_dispatch = spin_wait
            ex.Slot.synchronize = spin_sync
        try:
            if roundtrip:
                t, c = time.perf_counter(), time.process_time()
                list(ex.roundtrip_iter(images, s, workers=workers, device=dev))
                return (time.perf_counter() - t, time.process_time() - c), (0.0, 0.0)
            e = ex.PipelineEncoder(s, workers=workers, device=dev)
            d = ex.PipelineDecoder(workers=workers, device=dev)
            t, c = time.perf_counter(), time.process_time()
            out = e.encode_batch(images)
            enc_t = (time.perf_counter() - t, time.process_time() - c)
            t, c = time.perf_counter(), time.process_time()
            list(d.decode_iter(out))
            return enc_t, (time.perf_counter() - t, time.process_time() - c)
        finally:
            torch.set_num_threads(old_threads)
            ex.Slot.upload = orig_upload
            ex.Slot.wait_dispatch, ex.Slot.synchronize = orig_wait, orig_sync

    def one_shot():
        t, c = time.perf_counter(), time.process_time()
        out = [P.encode(img, s, device=dev) for img in images]
        enc_t = (time.perf_counter() - t, time.process_time() - c)
        t, c = time.perf_counter(), time.process_time()
        for b in out:
            P.decode(b, device=dev)
        return enc_t, (time.perf_counter() - t, time.process_time() - c)

    variants = {
        "one-shot": one_shot,
        "seq 4": lambda: stream(4),
        "seq 4, torch 1 thread": lambda: stream(4, threads=1),
        "seq 4, torch copies": lambda: stream(4, torch_copies=True),
        "seq 4, spin waits": lambda: stream(4, spin=True),
        f"seq {cpus}": lambda: stream(cpus),
        "roundtrip 4": lambda: stream(4, roundtrip=True),
        "roundtrip 4, torch 1 thread": lambda: stream(4, threads=1, roundtrip=True),
        "roundtrip 4, spin waits": lambda: stream(4, roundtrip=True, spin=True),
    }
    got: dict = {k: [] for k in variants}
    for turn in range(6):
        for k, fn in (variants.items() if turn % 2 else reversed(variants.items())):
            r = fn()
            if turn:
                got[k].append(r)
    for k, v in got.items():
        enc_w = statistics.median(e[0] for e, _ in v) * 1e3 / 12
        enc_c = statistics.median(e[1] for e, _ in v) * 1e3 / 12
        dec_w = statistics.median(d[0] for _, d in v) * 1e3 / 12
        dec_c = statistics.median(d[1] for _, d in v) * 1e3 / 12
        what = (f"encode and decode {enc_w:.2f} ms an image wall, {enc_c:.2f} CPU"
                if k.startswith("roundtrip") else
                f"encode {enc_w:.2f} ms an image wall, {enc_c:.2f} CPU; decode {dec_w:.2f} wall, "
                f"{dec_c:.2f} CPU")
        print(f"executor probe: {k}: {what} (medians of 5 turns) [{card}]", flush=True)


# ---------------------------------------------------------------- k8

#: the K8 kernels' common routes in loops, appended to csrc/rate.cu for
#: their SASS (chip_probe.py k8 never launches them): K8p's stage of one
#: thread on the fast route (stage_thread, finish_stage), K8s's 16-byte
#: route; the index that picks the thread's values moves each pass, so
#: nothing leaves the loop
K8_ROUTES = r"""
__global__ void __launch_bounds__(kThreads, 4)
    k8p_route(const int16_t* src, unsigned* out, int iters, const __grid_constant__ RateArgs r) {
    __shared__ RateTable t;
    __shared__ __align__(16) int16_t sv[kSlot];
    __shared__ int wl[2][kWarps];
    __shared__ int span_fm;
    load_rate_table(r, t);
    for (int i = threadIdx.x; i < kSlot; i += kThreads) sv[i] = src[i];
    if (threadIdx.x < 2 * kWarps) wl[threadIdx.x / kWarps][threadIdx.x % kWarps] = -1;
    __syncthreads();
    unsigned own = 0;
    int carry = -1, e = 1;
    for (int i = 0; i < iters; ++i) {
        const int at = (threadIdx.x + i) & (kThreads - 1);
        const Pending pd = stage_thread(t, r.segs, r.n, 4096 + kItems * at, 0, kItems,
                                        sv + 8 + kItems * at, e, own);
        own += finish_stage(pd, wl[i & 1], carry, &span_fm);
    }
    out[blockIdx.x * kThreads + threadIdx.x] = own + (unsigned)carry + (unsigned)e;
}

__global__ void __launch_bounds__(kThreads)
    k8s_route(const int16_t* src, int16_t* dst, int iters, const __grid_constant__ RateArgs r) {
    __shared__ RateTable t;
    load_rate_table(r, t);
    __syncthreads();
    int e = 1;
    for (int i = 0; i < iters; ++i) {
        const int p = kVec * ((int)threadIdx.x + i * kThreads);
        const uint4 x = *reinterpret_cast<const uint4*>(src + p);
        while (p >= t.start[e + 1]) ++e;
        if ((p > t.start[e] || !e) && p + kVec <= t.start[e + 1]) {
            union {
                uint4 u;
                int16_t v[kVec];
            } y;
            y.u = x;
            const uint32_t mul = t.mul[e];
            const int gate2 = t.gate2[e];
#pragma unroll
            for (int j = 0; j < kVec; ++j) y.v[j] = (int16_t)rate_body(y.v[j], mul, gate2);
            *reinterpret_cast<uint4*>(dst + p) = y.u;
        }
    }
}
"""
#: the vote before K8p's tokenizer, and its values' route for heads,
#: segments' ends and rows' ends; the variants of csrc/rate.cu that
#: k8_sass reads: "tok" tokenizes in every warp, "skip" in none, both
#: without that route (so that the loop holds the fast route alone)
K8_VOTE = "if (__any_sync(0xFFFFFFFFu, mm != 0))"
K8_SLOW = [("route = __reduce_max_sync(0xFFFFFFFFu, route);", "route = 0;"),
           ("const bool edge = lo != 0 || hi != kItems;", "const bool edge = false;")]
K8_VARIANTS = {"new": [], "tok": [(K8_VOTE, "if (true)"), *K8_SLOW],
               "skip": [(K8_VOTE, "if (false)"), *K8_SLOW]}
#: K8p's variants that k8 times beside it (source edits of csrc/rate.cu,
#: none of them but "clocked" computing the function): "skip" without the
#: tokenizer; "no_map", the values taken raw on the fast route; "no_items",
#: no thread's stage work (the copies, barriers, the leading positions'
#: step and the records); "small", without the route of heads, segments'
#: ends and spans' edges, "no_slow" without its route of values, and
#: "slow_untaken" with that route in the code but never taken;
#: "cta_finisher", every row finished by the whole CTA (finish_row), not
#: by warp 0 alone up to 32 spans; "as_is", no edit (built like the
#: variants, without K8_ROUTES); "clocked", as it is with thread 0's
#: clock64 at each CTA's start, each stage's data and work, and its span's
#: end
K8P_PARTS = {
    "skip": [(K8_VOTE, "if (false)")],
    "no_map": [("for (int j = 0; j < kItems; ++j) v[j + 1] = rate_body(x.h[j], mul, gate2);",
                "for (int j = 0; j < kItems; ++j) v[j + 1] = x.h[j];")],
    "no_items": [("pd = stage_thread(t, r.segs, n, first, lo, hi, sv, e, own);",
                  "pd = Pending{first, first - 1, 0, -1, -1, -1, false}; own += sv[0];")],
    "small": K8_SLOW,
    "no_slow": K8_SLOW[:1],
    "slow_untaken": [("route = __reduce_max_sync(0xFFFFFFFFu, route);",
                      "route = __reduce_max_sync(0xFFFFFFFFu, route) * (n < 0);")],
    "cta_finisher": [("if (a.cut.spr > 32)", "if (true)")],
    "as_is": [],

    "clocked": [("const int n = r.n, warp = threadIdx.x >> 5;",
                 "const int n = r.n, warp = threadIdx.x >> 5;\n"
                 "    long long* clk = k8_clock + 10 * blockIdx.x;\n"
                 "    if (threadIdx.x == 0) clk[0] = clock64();"),
                ("if (m) own += finish_stage(pd, warp_lm[(m - 1) & 1], carry, &span_fm);",
                 "if (threadIdx.x == 0 && m < 4) clk[1 + 2 * m] = clock64();\n"
                 "            if (m) own += finish_stage(pd, warp_lm[(m - 1) & 1], carry, &span_fm);"),
                ("if ((threadIdx.x & 31) == 31) warp_lm[m & 1][warp] = pd.incl;",
                 "if ((threadIdx.x & 31) == 31) warp_lm[m & 1][warp] = pd.incl;\n"
                 "            if (threadIdx.x == 0 && m < 4) clk[2 + 2 * m] = clock64();"),
                ("finish_row_warp(a, n, sp.row);\n        }",
                 "finish_row_warp(a, n, sp.row);\n        }\n"
                 "        if (threadIdx.x == 0) clk[9] = clock64();"),
                ("namespace {\n\nconstexpr int kThreads = 256;",
                 "__device__ long long k8_clock[10 * 4096];\n"
                 "extern \"C\" int ako_k8_clock(long long* out, int n) {\n"
                 "    return (int)cudaMemcpyFromSymbol(out, k8_clock, n * sizeof(long long));\n}\n"
                 "namespace {\n\nconstexpr int kThreads = 256;")],
}


def _k8_sources(other):
    """{name: ctypes library}: csrc/rate.cu with K8_ROUTES, as it is and
    in the K8_VARIANTS, and OTHER's rate.cu and kagari_encode.cu (K8s and
    K8p of a checkout before K8p left kagari_encode.cu), built side by
    side; each library's SASS beside it."""
    import chip_smoke as cs
    from ako_tpu_torch.runtime import kernels

    csrc = os.path.join(ROOT, "ako_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "rate.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    texts = {}
    for name, edits in [*K8_VARIANTS.items(), *((f"p_{k}", v) for k, v in K8P_PARTS.items())]:
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"k8 variant {name}: csrc/rate.cu has no {old!r}")
            text = text.replace(old, new)
        texts[name] = text + (K8_ROUTES if name in K8_VARIANTS else "")
    jobs = {}
    for name, text in texts.items():
        cu = os.path.join(csrc, f".k8_{name}.cu")  # beside its headers
        with open(cu, "w") as f:
            f.write(text)
        jobs[name] = [cu]
    if other:
        ocsrc = os.path.join(other, "ako_tpu_torch", "csrc")
        jobs["other"] = [os.path.join(ocsrc, "rate.cu")]
        if "rate_sizes" in open(os.path.join(ocsrc, "kagari_encode.cu")).read():
            jobs["other"].append(os.path.join(ocsrc, "kagari_encode.cu"))
    procs = {}
    for name, cus in jobs.items():
        so = os.path.join(OUT, f"k8_{name}.so")
        procs[name] = (subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so,
                                         *cus], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        for cu in jobs[name]:
            if os.path.basename(cu).startswith(".k8_"):
                os.remove(cu)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on k8 {name}:\n{log}")
        regs = [x.split("info    :")[-1].strip() for x in log.splitlines()
                if "registers" in x or "Compiling entry" in x]
        print(f"k8 {name}: ptxas {regs}", flush=True)
        lib = ctypes.CDLL(so)
        new_abi = hasattr(lib, "ako_rate_sizes_ctas")
        lib.ako_rate_sizes.restype = lib.ako_rate_serialize.restype = ctypes.c_int
        lib.ako_rate_serialize.argtypes = kernels._SIGNATURES["ako_rate_serialize"]
        lib.ako_rate_sizes.argtypes = (kernels._SIGNATURES["ako_rate_sizes"] if new_abi else
                                       [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_uint, ctypes.c_int,
                                        ctypes.POINTER(kernels.RateArgs), ctypes.c_void_p])
        if new_abi:
            lib.ako_rate_sizes_ctas.restype = ctypes.c_int
            lib.ako_rate_sizes_ctas.argtypes = kernels._SIGNATURES["ako_rate_sizes_ctas"]
        libs[name] = (lib, new_abi, cs.cuobjdump_sass(so) if name in K8_VARIANTS else "")
    return libs


def k8_sass(libs, card) -> dict:
    """Each route's loop in SASS (the largest loop of k8p_route and
    k8s_route: instructions a pass, and a value), written to
    build/probe/k8_sass_<variant>.txt with the kernels' own; returns
    {"k8s": K8s's instructions a value, "k8p": K8p's without the
    tokenizer, "k8p_tokenize": what the tokenizer adds}."""
    import chip_smoke as cs

    per = {}
    for name in K8_VARIANTS:
        funcs = cs.sass_functions(libs[name][2])
        with open(os.path.join(OUT, f"k8_sass_{name}.txt"), "w") as f:
            for k, insns in funcs.items():
                f.write(f"Function : {k}\n")
                f.writelines(f"  {ad:#06x}  {t:<56} {c}\n" if ad is not None else f"{t}:\n"
                             for ad, t, c in insns)
        for route, values in (("k8p_route", 16), ("k8s_route", 8)):
            insns = [v for k, v in funcs.items() if route in k][0]
            loop = max(cs.sass_loops(insns, innermost=False), key=lambda lp: len(lp[2]))
            per[name, route] = len(loop[2]) / values
            print(f"k8 sass {name} {route}: loop {loop[0]:#x}-{loop[1]:#x}, {len(loop[2])} "
                  f"instructions a pass of {values} values: {per[name, route]:.2f} a value "
                  f"[{card}]", flush=True)
    out = {"k8s": per["new", "k8s_route"], "k8p": per["skip", "k8p_route"],
           "k8p_tokenize": per["tok", "k8p_route"] - per["skip", "k8p_route"]}
    print(f"k8 instructions a value: {json.dumps({k: round(v, 2) for k, v in out.items()})} "
          f"[{card}]", flush=True)
    return out


def k8p_parts(libs, ctas: int, dev, img, card: str) -> None:
    """K8p and its K8P_PARTS variants in turns (each, then again in
    reverse) on the north star's and the whole tile's raw pyramids at
    q 16: device ms (the profiler's median of 20) and CUDA events; then
    the clocked variant's cycles a CTA: from its start to its first
    stage's data, each stage's wait and work, and its span's end
    (medians and maxima over CTAs), beside the SM clock a cycle."""
    import statistics

    import torch

    import ako_tpu_torch as P
    import chip_smoke as cs
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import tile_qg
    from ako_tpu_torch.ops import rate_device as rd
    from ako_tpu_torch.tools.rate import _CachedEncoder

    cur = torch.cuda.current_stream().cuda_stream
    names = ["new"] + [f"p_{k}" for k in K8P_PARTS]
    for setting, tiles in (("north_t128", 128), ("whole", 0)):
        enc = _CachedEncoder(img, P.Settings(tiles_dimension=tiles), dev)
        ((tl, raw),) = enc._tile_pyramids(enc._settings_at(16))
        tw, th, ch = tl[0].w, tl[0].h, img.shape[2]
        schedule = geometry.lift_schedule(tw, th)
        args = rd.rate_args(schedule, ch, *rd.probe_qg(tile_qg(tw, th, ch, 16, 0, 1), ch))
        rows = raw.shape[0]
        spans = max(rows, 64 * ctas)  # the variants' grids differ from "new"'s
        scratch = torch.zeros((rd.sizes_scratch_words(rows, spans),), dtype=torch.int64,
                              device=dev)
        sizes = torch.empty((rows,), dtype=torch.int64, device=dev)
        want = rd.probe_sizes_plain(raw, schedule, ch, *rd.probe_qg(tile_qg(tw, th, ch, 16, 0, 1),
                                                                   ch))
        times = {}
        for name in names + names[::-1]:
            lib = libs[name][0]

            def call(lib=lib):
                rc = lib.ako_rate_sizes(raw.data_ptr(), sizes.data_ptr(), scratch.data_ptr(),
                                        scratch.numel(), rows, spans, rows, ctypes.byref(args), cur)
                if rc:
                    raise RuntimeError(f"k8 {name}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            computes = ("new", "p_clocked", "p_cta_finisher", "p_as_is")
            if name in computes and not torch.equal(sizes, want):
                raise AssertionError(f"k8 {name} != plain on {setting}")
            times.setdefault(name, []).append((round(cs._launch_ms(call, "rate_sizes"), 4),
                                               round(cs._event_ms(call), 4)))
        print(f"k8 parts {setting} {tuple(raw.shape)} q 16: (profiler ms, event ms) {times} "
              f"[{card}]", flush=True)
        lib = libs["p_clocked"][0]
        lib.ako_k8_clock.restype = ctypes.c_int
        lib.ako_k8_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
        grid = ctypes.c_int(0)
        lib.ako_rate_sizes_ctas(ctypes.byref(grid))
        buf = (ctypes.c_longlong * (10 * min(grid.value, rows * rd.span_cut(
            rows, raw.shape[1], grid.value)[0])))()
        if lib.ako_k8_clock(buf, len(buf)):
            raise RuntimeError("k8: ako_k8_clock failed")
        c = [list(buf[10 * i : 10 * i + 10]) for i in range(len(buf) // 10)]
        parts = {"start_to_stage0_data": [x[1] - x[0] for x in c],
                 "stage0_work": [x[2] - x[1] for x in c],
                 "stage1_wait": [x[3] - x[2] for x in c if x[3] > x[2]],
                 "stage1_work": [x[4] - x[3] for x in c if x[4] > x[3]],
                 "stage2_wait": [x[5] - x[4] for x in c if x[5] > x[4]],
                 "stage2_work": [x[6] - x[5] for x in c if x[6] > x[5]],
                 "to_span_end": [x[9] - max(x[1:9]) for x in c],
                 "cta_total": [x[9] - x[0] for x in c]}
        slow = sorted(range(len(c)), key=lambda i: c[i][9] - c[i][0])[-8:]
        print(f"k8 clocked {setting}: cycles a CTA (median, max, CTAs) "
              f"{ {k: (int(statistics.median(v)), max(v), len(v)) for k, v in parts.items() if v} }; "
              f"the slowest CTAs (CTA, cycles) {[(i, c[i][9] - c[i][0]) for i in slow]}; "
              f"stamps from each CTA's start of the 3 slowest and CTAs 1, 2, 3: "
              f"{ {i: [x - c[i][0] for x in c[i][1:]] for i in slow[-3:] + [1, 2, 3]} } "
              f"[{card}]", flush=True)


def k8p_finisher(libs, ctas: int, dev, img, card: str) -> None:
    """K8p as it is ("as_is", built as the variants are) against its
    "cta_finisher" variant (every row finished by the whole CTA) on the
    north star's raw pyramid (6 spans a row) at q 0, 16, 64 and 256: 3
    rounds of turns (as_is, cta_finisher, cta_finisher, as_is), each
    call checked against the plain version and timed by the profiler
    (median of 20) and CUDA events (50 calls); each variant's median and
    spread (max - min over its 6 turns)."""
    import statistics

    import torch

    import ako_tpu_torch as P
    import chip_smoke as cs
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import tile_qg
    from ako_tpu_torch.ops import rate_device as rd
    from ako_tpu_torch.tools.rate import _CachedEncoder

    cur = torch.cuda.current_stream().cuda_stream
    enc = _CachedEncoder(img, P.Settings(tiles_dimension=128), dev)
    for q in (0, 16, 64, 256):
        ((tl, raw),) = enc._tile_pyramids(enc._settings_at(q))
        tw, th, ch = tl[0].w, tl[0].h, img.shape[2]
        schedule = geometry.lift_schedule(tw, th)
        qs, gs = rd.probe_qg(tile_qg(tw, th, ch, q, 0, 1), ch)
        args = rd.rate_args(schedule, ch, qs, gs)
        rows = raw.shape[0]
        spans = max(rows, ctas)
        scratch = torch.zeros((rd.sizes_scratch_words(rows, spans),), dtype=torch.int64,
                              device=dev)
        sizes = torch.empty((rows,), dtype=torch.int64, device=dev)
        want = rd.probe_sizes_plain(raw, schedule, ch, qs, gs)
        times = {}
        for name in ["p_as_is", "p_cta_finisher", "p_cta_finisher", "p_as_is"] * 3:
            lib = libs[name][0]

            def call(lib=lib, name=name):
                rc = lib.ako_rate_sizes(raw.data_ptr(), sizes.data_ptr(), scratch.data_ptr(),
                                        scratch.numel(), rows, spans, rows, ctypes.byref(args), cur)
                if rc:
                    raise RuntimeError(f"k8 {name}: cudaError {rc}")

            sizes.zero_()
            call()
            torch.cuda.synchronize()
            if not torch.equal(sizes, want):
                raise AssertionError(f"k8 {name} != plain on the north star at q {q}")
            times.setdefault(name, []).append((cs._launch_ms(call, "rate_sizes"),
                                               cs._event_ms(call)))
        summary = {}
        for name, t in times.items():
            for i, how in enumerate(("profiler", "events")):
                v = [x[i] for x in t]
                summary[name, how] = (round(statistics.median(v), 5), round(max(v) - min(v), 5))
        print(f"k8 finisher north_t128 {tuple(raw.shape)} q {q}: (median ms, spread ms) "
              f"{ {f'{k[0]} {k[1]}': v for k, v in summary.items()} }; turns "
              f"{ {k: [(round(a, 5), round(b, 5)) for a, b in v] for k, v in times.items()} } "
              f"[{card}]", flush=True)


def k8(other, card: str) -> None:
    """K8p and K8s of this checkout and of OTHER's, side by side in one
    process: each checked against its plain version, then timed in turns
    (other, new, new, other) on the raw pyramids of the north star at
    128-px tiles (80 x 65,560) and on the whole tile (1 x 5,242,932) at
    q 0, 16, 64 and 256 (gate 0): device ms a launch (the profiler's median
    of 20) and CUDA events around 50; the bounds (chip_smoke.rate_bounds_ms)
    beside the routes' SASS instructions a value (k8_sass)."""
    import torch

    import ako_tpu_torch as P
    import chip_smoke as cs
    from ako_tpu_torch.core import geometry
    from ako_tpu_torch.encode import tile_qg
    from ako_tpu_torch.ops import rate_device as rd
    from ako_tpu_torch.tools.rate import _CachedEncoder
    from ako_tpu_torch.utils.corpus import corpus

    libs = _k8_sources(other)
    ops = k8_sass(libs, card)
    order = ["new"] + (["other"] if other else [])
    turns = order[::-1] + order if other else order * 2
    dev = torch.device("cuda:0")
    cur = torch.cuda.current_stream().cuda_stream
    img = corpus(42, 1, 1280, 1024, 4)[0]
    ctas = ctypes.c_int(0)
    if libs["new"][0].ako_rate_sizes_ctas(ctypes.byref(ctas)):
        raise RuntimeError("k8: ako_rate_sizes_ctas failed")
    epoch = [0]
    for setting, tiles in (("north_t128", 128), ("whole", 0)):
        enc = _CachedEncoder(img, P.Settings(tiles_dimension=tiles), dev)
        for q in (0, 16, 64, 256):
            ((tl, raw),) = enc._tile_pyramids(enc._settings_at(q))
            tw, th, ch = tl[0].w, tl[0].h, img.shape[2]
            schedule = geometry.lift_schedule(tw, th)
            qs, gs = rd.probe_qg(tile_qg(tw, th, ch, q, 0, 1), ch)
            args = rd.rate_args(schedule, ch, qs, gs)
            rows, n = raw.shape
            want = rd.serialize_plain(raw, schedule, ch, qs, gs)
            want_sizes = rd.probe_sizes_plain(raw, schedule, ch, qs, gs)
            sass = cs.k8_sass_per_value(want)
            spans = max(rows, ctas.value)
            new_scratch = torch.zeros((rd.sizes_scratch_words(rows, spans),), dtype=torch.int64,
                                      device=dev)
            chunks = rows * -(-n // 4096)
            old_scratch = torch.zeros((chunks + rows + 1,), dtype=torch.int64, device=dev)
            out = torch.empty_like(raw)
            sizes = torch.empty((rows,), dtype=torch.int64, device=dev)
            times = {}
            for name in turns:
                lib, new_abi, _ = libs[name]

                def k8p(lib=lib, new_abi=new_abi):
                    if new_abi:
                        rc = lib.ako_rate_sizes(raw.data_ptr(), sizes.data_ptr(),
                                                new_scratch.data_ptr(), new_scratch.numel(), rows,
                                                spans, rows, ctypes.byref(args), cur)
                    else:
                        epoch[0] += 1
                        rc = lib.ako_rate_sizes(raw.data_ptr(), sizes.data_ptr(),
                                                old_scratch.data_ptr(), old_scratch.numel(), rows,
                                                chunks, epoch[0], rows, ctypes.byref(args), cur)
                    if rc:
                        raise RuntimeError(f"k8 {name}: ako_rate_sizes cudaError {rc}")

                def k8s(lib=lib):
                    rc = lib.ako_rate_serialize(raw.data_ptr(), out.data_ptr(), rows,
                                                ctypes.byref(args), cur)
                    if rc:
                        raise RuntimeError(f"k8 {name}: ako_rate_serialize cudaError {rc}")

                for kname, fn, got, ref in (("rate_sizes", k8p, sizes, want_sizes),
                                            ("rate_serialize", k8s, out, want)):
                    got.zero_()
                    fn()
                    torch.cuda.synchronize()
                    if not torch.equal(got, ref):
                        raise AssertionError(f"k8 {name} {kname} != plain on {setting} q {q}")
                    times.setdefault((name, kname), []).append(
                        (round(cs._launch_ms(fn, kname), 4), round(cs._event_ms(fn), 4)))
            bound = cs.rate_bounds_ms((rows, n))
            for (name, kname), t in sorted(times.items(), key=lambda x: (x[0][1], x[0][0])):
                print(f"k8 {setting} {tuple(raw.shape)} q {q} {kname} {name}: (profiler ms, event "
                      f"ms) {t}; bound {bound[kname][0]:.5f} ms by {bound[kname][1]}; the "
                      f"kernel's SASS instructions a value {sass[kname]} (diagnostic) [{card}]",
                      flush=True)
    k8p_parts(libs, ctas.value, dev, img, card)
    k8p_finisher(libs, ctas.value, dev, img, card)
    print(f"k8: ctas {ctas.value}; SASS instructions a value: K8S_SASS {ops['k8s']:.2f}, "
          f"K8P_SASS {ops['k8p']:.2f}, K8P_SASS_TOKENIZE {ops['k8p_tokenize']:.2f} "
          f"(chip_smoke.py's: {cs.K8S_SASS}, {cs.K8P_SASS}, {cs.K8P_SASS_TOKENIZE}) [{card}]",
          flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2 or sys.argv[1] not in (
            "compare", "k3", "k4", "k6", "k6d", "k8", "levels", "split", "profiler",
            "profiler-child", "executor"):
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
    elif sys.argv[1] == "k6":
        k6(other, card)
    elif sys.argv[1] == "k6d":
        k6d(other, card)
    elif sys.argv[1] == "k8":
        k8(other, card)
    elif sys.argv[1] == "split":
        split(other, card)
    elif sys.argv[1] == "profiler":
        profiler(card)
    elif sys.argv[1] == "profiler-child":
        profiler_child(card)
    elif sys.argv[1] == "executor":
        executor(card)
    else:
        k4(other, card)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["k6d"], ["k8"]):
        # their profiled windows are many and short: CUPTI torn down after
        # each (chip_smoke.py's setting), so the process ends with os._exit
        os.environ.setdefault("TEARDOWN_CUPTI", "1")
    if sys.argv[1:2] in (["profiler-child"], ["k6d"], ["k8"]):
        # a process that tore CUPTI down (TEARDOWN_CUPTI=1) hangs in its
        # exit, as chip_smoke.py's would
        code = main()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    sys.exit(main())

#!/usr/bin/env python3
"""Probes of the port on one CUDA card that go past chip_smoke.py: a
comparison with another checkout, and where kernel K4's time goes.

    python3 chip_probe.py compare OTHER   # OTHER: the root of another checkout
    python3 chip_probe.py k4 [OTHER]

compare: the device-entropy north star (128-px tiles, fused wiring) in
turns OTHER, this, this, OTHER, each in its own process: encode and
decode medians (two of 7 runs each), one profiled encode and decode
(wall, host enqueue, device busy ms, device ms per kernel), their event
stages on the host clock, and K4 alone (CUDA events). OTHER is unpacked
with `git archive` into a directory that git ignores (build/).

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
version. Every line carries the card's name and power limit.
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


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2 or sys.argv[1] not in ("compare", "k4"):
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
    else:
        k4(other, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

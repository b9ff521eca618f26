"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, the check against the reference, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import enum
import gc
import importlib
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import check, trace
from portbench.harness.pool import make_pool
from portbench.harness.registry import Bench

#: top-level modules that may not be in the process once the window has
#: closed: JAX and the JAX package (compared whole: the port's own name
#: begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "ako_tpu")
#: the program's package, whose modules' LAUNCHES are its launch counters
PROGRAM = "ako_tpu_torch"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def port_api(entries: dict) -> SimpleNamespace:
    """The program's entry points a loop drives: {name: "module:attr"}."""
    api = {}
    for name, target in entries.items():
        module, attr = target.split(":")
        api[name] = getattr(importlib.import_module(module), attr)
    return SimpleNamespace(**api)


def port_settings(d: dict):
    """ako_tpu_torch.Settings from a configuration's `settings`: field
    names, and enum members by name."""
    from ako_tpu_torch import Settings

    defaults = {f.name: f.default for f in dataclasses.fields(Settings)}
    return Settings(**{k: type(defaults[k])[v] if isinstance(defaults[k], enum.Enum) else v
                       for k, v in d.items()})


def launch_counts() -> dict:
    """The port's launch counters (runtime/kernels.py count_launch): the
    LAUNCHES of every module of the program loaded."""
    out: dict = {}
    for name, module in list(sys.modules.items()):
        launches = getattr(module, "LAUNCHES", None)
        if name.split(".")[0] == PROGRAM and isinstance(launches, dict):
            out.update(launches)
    return out


class GcPauses:
    """The collector's passes while installed: count and ms by generation."""

    def __init__(self):
        self.ms = {0: [], 1: [], 2: []}
        self._t0 = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.ms[info["generation"]].append((time.perf_counter() - self._t0) * 1e3)

    def line(self) -> str:
        return "gc in the window: " + "; ".join(
            f"gen {g} {len(v)} passes, {sum(v):.2f} ms, longest {max(v, default=0):.3f} ms"
            for g, v in self.ms.items())


def card_lines() -> list:
    """What nvidia-smi says of the card: name, power limit, clocks."""
    query = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi: not available ({e})"]
    return [f"nvidia-smi {query}: {line}" for line in out.strip().splitlines()]


def run(bench: Bench, workload: str, seed: int, seconds: float, traced: bool, t0: float,
        device: str = "cuda", api=None, say=print) -> dict:
    """One run; returns the result line's object. `device` "cpu" and a
    substitute `api` are for the tests, which run no card."""
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    loops = bench.loop(mix["loop"])
    api = api or port_api(loops.ENTRIES)
    if "torch_threads" in mix:
        torch.set_num_threads(mix["torch_threads"])
    on_card = device == "cuda"
    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    if on_card:
        from ako_tpu_torch.runtime import build, kernels

        kernels.load()
        build.load()
    pool = make_pool(config, seed, dev)
    loop = loops.Loop(mix, config, api, pool, port_settings(config["settings"]), seed,
                      None if on_card else "cpu")
    loop.warm()
    if on_card:
        torch.cuda.synchronize()
    # the set-up's objects (torch's, the program's, the pool) out of the
    # collector's reach: a full pass over them stalled a request by
    # 110-130 ms, twice a window, on the card's host
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    from ako_tpu_torch.utils import metrics as counters

    counters.reset()
    before = launch_counts()
    annotate = lambda name: contextlib.nullcontext()
    prof = contextlib.nullcontext()
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        annotate = record_function
        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if on_card else []))
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    with prof:
        with annotate("portbench.window"):
            res = loop.window(seconds, traced, annotate)
        if on_card:
            torch.cuda.synchronize()
    gc.callbacks.remove(pauses)
    res.setup_s = setup_s
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    launched = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
    fallbacks = counters.fallback_summary()
    loop.close()
    del loop

    out = {"correct": False, "attempted": res.attempted, "failed": res.failed, "metrics": {}}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if traced:
        window = trace.read_profile(prof, config, res.requests)
        missing = trace.launches_missing(window, launched)
        if missing:
            raise RuntimeError(f"the trace lost device kernels, (launched, traced): {missing}")
        lo, hi = window.ranges["portbench.window"][0]
        device_info["busy_s"] = window.busy_in(lo, hi) / 1e6
        device_info["window_s"] = (hi - lo) / 1e6
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"])(window)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = trace.breakdown(window)
        del window, prof
    else:
        for m in bench.end_to_end(workload):
            value = bench.metric(m["name"])(res, mix, config)
            if value is None:
                raise RuntimeError(f"the window gave nothing to read for {m['name']}")
            out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    out["device"] = device_info

    for kind in dict.fromkeys(r.kind for r in res.requests):
        ms = res.ms_of(kind)
        say(f"{kind}: {len(ms)} requests, median {np.median(ms):.4f} ms, "
            f"p95 {np.percentile(ms, 95):.4f} ms, max {max(ms):.4f} ms")
    if res.images_done:
        say(f"images completed: {res.images_done} in {res.seconds} s")
    say(f"setup_s {setup_s:.4f}; launches in the window {launched}")
    say(f"fallback counters {fallbacks}; os.cpu_count() {os.cpu_count()}; "
        f"torch threads {torch.get_num_threads()}")
    say(pauses.line())
    if on_card:
        for line in card_lines():
            say(line)

    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    expected = check.Expected(config, mix, pool, dev, loops.reference)
    numbers = check.compare(res.kept, res.failed, expected)
    out["correct"] = check.is_correct(numbers)
    say(f"checked {len(res.kept)} answers of {res.attempted} against the reference in "
        f"{time.perf_counter() - t_check:.2f} s")
    out["compared"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}
    return out


def main(argv: list, t0: float, root: str) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = Bench(root)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(bench, args.workload, args.seed, args.seconds, bool(args.trace), t0)
    bad = forbidden_modules()
    print(f"modules: no top-level {', '.join(FORBIDDEN)} in sys.modules: {not bad}")
    if bad:
        print(f"portbench: the process holds {bad}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        print(f"compared {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0

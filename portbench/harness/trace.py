"""The traced window: torch.profiler over the whole measured window, and
what the per-layer readers read from it.

The profiler records the device's kernels and copies (CUPTI) beside the
host's ranges. The harness names its ranges `portbench.<kind>` around
each request (`encode`, `decode`, `search`), `portbench.stream` around
the stream's window and `portbench.window` around every window, and in
traced requests `portbench.<kind>.<STAGE>` around each core.events stage
of the program. Readers get a `Window`: these ranges, the device's
intervals, the port's kernels by name, the requests of the window and
the configuration.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

#: the port's kernels, by the name their profiler events carry
#: (demangled "ns::lift_pyramid(...)" or mangled "...12lift_pyramidE...")
PORT_KERNELS = (
    "lift2d", "unlift2d", "lift_h", "lift_v", "unlift_h", "unlift_v", "vlift", "vunlift",
    "lift_pyramid", "unlift_pyramid", "lift_level", "unlift_level", "lift_level_shards",
    "unlift_level_shards", "kagari_encode", "kagari_decode", "manba_stats", "manba_model",
    "manba_chain_pack", "manba_decode", "rate_serialize", "rate_sizes",
)
KERNEL_RE = re.compile(r"(?:^|::|\d|\s)(" + "|".join(PORT_KERNELS) + r")[<(IE]")
#: the launch counters (runtime/kernels.py count_launch) whose launches
#: each put one kernel of the same name on the device
COUNTED = ("lift2d", "unlift2d", "vlift", "vunlift", "lift_pyramid", "unlift_pyramid",
           "lift_level", "unlift_level", "lift_level_shards", "unlift_level_shards",
           "kagari_encode", "kagari_decode", "manba_decode", "rate_serialize", "rate_sizes")


def kernel_name(name: str) -> str | None:
    m = KERNEL_RE.search(name)
    return m.group(1) if m else None


def short_name(name: str) -> str:
    """A device event's name for the breakdown: the port's kernel, the
    copy's kind, or the first 60 characters."""
    k = kernel_name(name)
    if k:
        return k
    if "Memcpy" in name or "Memset" in name:
        return name.split(" (")[0]
    return name[:60]


def union(spans) -> list:
    """Sorted (start, end) spans merged where they overlap."""
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Window:
    """What a per-layer reader reads (times in microseconds on the
    profiler's clock, but Request.ms and stages, which are host-clock ms)."""

    config: dict
    requests: list
    ranges: dict  # name -> [(start, end)] of the harness's ranges
    device: list  # [(start, end, name)] of the device's kernels and copies
    busy: list = field(default_factory=list)  # union of device intervals

    def __post_init__(self):
        self.busy = union((a, b) for a, b, _ in self.device)
        self._starts = [a for a, _ in self.busy]

    def requests_of(self, kind: str) -> list:
        return [r for r in self.requests if r.kind == kind]

    def kernel_us(self, *names: str) -> float:
        """Device microseconds of the port's kernels of these names."""
        return sum(b - a for a, b, n in self.device if kernel_name(n) in names)

    def kernels(self, name: str) -> int:
        return sum(1 for _, _, n in self.device if kernel_name(n) == name)

    def busy_in(self, a: float, b: float) -> float:
        """Microseconds within [a, b] in which the device ran something."""
        i = max(bisect.bisect_right(self._starts, a) - 1, 0)
        total = 0.0
        while i < len(self.busy) and self.busy[i][0] < b:
            s, e = self.busy[i]
            total += max(0.0, min(e, b) - max(s, a))
            i += 1
        return total

    def idle_share(self, kind: str) -> float | None:
        """Percent of the wall time of the ranges `portbench.<kind>` in
        which the device ran nothing; None without such ranges."""
        spans = self.ranges.get(f"portbench.{kind}", [])
        wall = sum(b - a for a, b in spans)
        if not wall:
            return None
        return 100.0 * (1.0 - sum(self.busy_in(a, b) for a, b in spans) / wall)


def read_profile(prof, config: dict, requests: list) -> Window:
    """The Window of a finished torch.profiler.profile, from its raw
    events (building the profiler's event tree takes minutes over a
    window of a few hundred thousand events)."""
    from torch.autograd import DeviceType

    ranges: dict = {}
    device = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        span = (start, start + e.duration_ns() / 1e3)
        name = e.name()
        if name.startswith("portbench."):
            if e.device_type() != DeviceType.CUDA:
                ranges.setdefault(name, []).append(span)
        elif e.device_type() == DeviceType.CUDA:
            device.append((*span, name))
    for v in ranges.values():
        v.sort()
    device.sort()
    return Window(config, requests, ranges, device)


def launches_missing(window: Window, launched: dict) -> dict:
    """{kernel: (launched, traced)} where the trace holds fewer kernels
    of a name than the program counted launches of it."""
    out = {}
    for name in COUNTED:
        n = launched.get(name, 0)
        traced = window.kernels(name)
        if traced < n:
            out[name] = (n, traced)
    return out


def breakdown(window: Window, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time inside the window by the innermost harness range open on the
    host at the gap's middle (the stage of the program the host was in),
    each as [[name, seconds], ...]."""
    ops: dict = {}
    for a, b, n in window.device:
        k = short_name(n)
        ops[k] = ops.get(k, 0.0) + (b - a) / 1e6
    lo, hi = window.ranges.get("portbench.window", [(0.0, 0.0)])[0]
    gaps = []
    prev = lo
    for a, b in window.busy:
        if min(a, hi) > prev:
            gaps.append((prev, min(a, hi)))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    spans = sorted((a, b, name) for name, v in window.ranges.items() for a, b in v
                   if name != "portbench.window")
    idle: dict = {}
    active: list = []  # ranges open at the last gap's middle
    j = 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while j < len(spans) and spans[j][0] <= mid:
            active.append(spans[j])
            j += 1
        active = [s for s in active if s[1] >= mid]
        label = max(active)[2].removeprefix("portbench.") if active else "outside any request"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}

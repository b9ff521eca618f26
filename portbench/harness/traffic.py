"""What every traffic loop shares. A mix's data file
(`traffic/<mix>.json`) names a `loop`, and `loops/<loop>.py` drives the
program's entry points through the measured window with the mix's
parameters (and, optionally, `torch_threads`: torch's CPU threads for
the run); a new mix of an existing loop is data only, a new kind of
traffic a new file in loops/.

A loop file holds:
- `ENTRIES`: {name: "module:attribute"}, the program's entry points it
  calls, which the harness imports and hands it as `self.api`;
- `Loop`, a subclass of `Loop` below, with `warm()` (set-up),
  `window(seconds, traced, annotate)` (measured; returns a `Result`) and
  `close()`;
- `reference(enc, mix)`: the plain reference's answer for one pool
  image, given its `reference.codec.Encoder`, as a dict of the same
  parts as the loop's kept answers (`blob`, `pixels`, `q`).

Every loop keeps a sample of its answers for the check: the first pass
over the pool, and one answer in `SAMPLE_EVERY` after it, drawn from the
seed.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field

import numpy as np

#: after the first pass over the pool, one answer in this many is kept
SAMPLE_EVERY = 8


@dataclass
class Request:
    """One timed request: its kind, host-clock ms, the event stages' ms
    (traced runs), and the bytes of payload it carried."""

    kind: str
    ms: float
    stages: dict = field(default_factory=dict)
    payload_bytes: int = 0


@dataclass
class Result:
    """A window's requests, its kept answers [(pool image, {part:
    answer})], the requests attempted and failed, its length, the images
    a stream completed, and the run's set-up seconds."""

    requests: list = field(default_factory=list)
    kept: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    seconds: float = 0.0
    images_done: int = 0
    setup_s: float = 0.0

    def ms_of(self, kind: str) -> list:
        """Host-clock ms of the window's requests of this kind."""
        return [r.ms for r in self.requests if r.kind == kind]


class Sampler:
    """Which answers the check reads: the first pass over the pool, then
    one in SAMPLE_EVERY, drawn from the seed."""

    def __init__(self, seed: int, pool: int):
        self.pool = pool
        self.rng = np.random.default_rng([seed % 2**63, 0xA0B])
        self.mask = np.zeros(0, bool)

    def keep(self, i: int) -> bool:
        if i < self.pool:
            return True
        while i >= len(self.mask):
            self.mask = np.concatenate([self.mask, self.rng.random(4096) < 1 / SAMPLE_EVERY])
        return bool(self.mask[i])


class Stages:
    """The events callback of a traced request (core.events): each
    stage's host-clock ms, and a profiler range around it named
    `portbench.<kind>.<stage>` so that the trace shows what the host did."""

    def __init__(self, kind: str, annotate):
        self.kind = kind
        self.annotate = annotate
        self.ms: dict = {}
        self._open: dict = {}

    def __call__(self, tile, total, event, user) -> None:
        name = event.name
        stage = name.rsplit("_", 1)[0]
        if name.endswith("START"):
            rng = self.annotate(f"portbench.{self.kind}.{stage}")
            rng.__enter__()
            self._open[stage] = (time.perf_counter(), rng)
        else:
            t0, rng = self._open.pop(stage)
            self.ms.setdefault(stage, []).append((time.perf_counter() - t0) * 1e3)
            rng.__exit__(None, None, None)


class Loop:
    """A loop over the pool: `warm()` in set-up, `window()` measured.
    `options` are the configuration's `entry_options`, keyword arguments
    of the entry points (such as device_entropy)."""

    def __init__(self, mix: dict, config: dict, api, pool: list, settings, seed: int, device):
        self.mix = mix
        self.config = config
        self.api = api
        self.pool = pool
        self.settings = settings
        self.options = dict(config.get("entry_options", {}))
        self.sampler = Sampler(seed, len(pool))
        self.device = device

    def _timed(self, kind: str, fn, traced: bool, annotate):
        """(answer, Request) of fn(events), annotated and timed."""
        stages = Stages(kind, annotate) if traced else None
        with annotate(f"portbench.{kind}"):
            t0 = time.perf_counter()
            answer = fn(stages)
            ms = (time.perf_counter() - t0) * 1e3
        return answer, Request(kind, ms, stages.ms if stages else {})

    def close(self) -> None:
        """Stop what the loop started (nothing, but for the stream)."""

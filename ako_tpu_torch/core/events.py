"""Per-stage event hooks (tracing / profiling).

The codec fires START/END pairs through a user callback
`events(tile_no, total_tiles, event, user_data)` (reference
library/ako.h:75-84). The device stage runs per tile-shape group, so
FORMAT and WAVELET fire once per group (tile_no = the group's first
tile), as in ako_tpu's device paths; AKO_TPU_EVENTS=tile and the host
modes (AKO_TPU_ENCODE=host, AKO_TPU_DECODE=host) fire every pair per
tile, as the reference does.
"""

from __future__ import annotations

import enum
import time
from typing import Callable, Optional


class Event(enum.IntEnum):
    """Values match the reference enum exactly (library/ako.h:75-84,
    NONE = 0 first)."""

    NONE = 0
    FORMAT_START = 1
    FORMAT_END = 2
    WAVELET_START = 3
    WAVELET_END = 4
    COMPRESSION_START = 5
    COMPRESSION_END = 6


EventsCallback = Callable[[int, int, Event, object], None]


class Stopwatch:
    """Pause/accumulate stopwatch (reference tools/benchmark.hpp:39-62):
    one instance per stage, accumulating across tiles."""

    def __init__(self):
        self.total = 0.0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def pause_and_accumulate(self):
        if self._t0 is not None:
            self.total += time.perf_counter() - self._t0
            self._t0 = None

    @property
    def milliseconds(self) -> float:
        return self.total * 1e3


class EventsData:
    """Accumulating per-stage timers fed by the event callback
    (reference tools/benchmark.hpp:65-90); the CLIs' -b flag."""

    def __init__(self):
        self.format = Stopwatch()
        self.wavelet = Stopwatch()
        self.compression = Stopwatch()

    def callback(self, tile_no: int, total_tiles: int, event: Event, user) -> None:
        if event == Event.FORMAT_START:
            self.format.start()
        elif event == Event.FORMAT_END:
            self.format.pause_and_accumulate()
        elif event == Event.WAVELET_START:
            self.wavelet.start()
        elif event == Event.WAVELET_END:
            self.wavelet.pause_and_accumulate()
        elif event == Event.COMPRESSION_START:
            self.compression.start()
        elif event == Event.COMPRESSION_END:
            self.compression.pause_and_accumulate()

    def summary(self) -> str:
        return (
            f"Benchmark: {self.format.milliseconds:.2f} ms format, "
            f"{self.wavelet.milliseconds:.2f} ms wavelet transformation, "
            f"{self.compression.milliseconds:.2f} ms compression"
        )


def fire(events, tile_no: int, total: int, event: Event, user) -> None:
    if events is not None:
        events(tile_no, total, event, user)

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
from typing import Callable


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


def fire(events, tile_no: int, total: int, event: Event, user) -> None:
    if events is not None:
        events(tile_no, total, event, user)

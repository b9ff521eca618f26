"""Developer logging, env-gated: a copy of ako_tpu/utils/debug.py.

The reference's compile-time AKO_DEV_PRINTF (library/ako-private.h:11-18)
becomes a runtime switch: set AKO_TPU_DEV=1 to enable. The reference
also rate-limits per-tile noise to the first 10 tiles (AKO_DEV_NOISE,
encode.c:187-196); dev_tile_printf applies the same cap."""

from __future__ import annotations

import os
import sys

DEV_NOISE_MAX_TILES = 10


def dev_enabled() -> bool:
    return os.environ.get("AKO_TPU_DEV", "0") not in ("", "0")


def dev_printf(fmt: str, *args) -> None:
    if dev_enabled():
        print(fmt % args if args else fmt, file=sys.stderr)


def dev_tile_printf(tile_no: int, fmt: str, *args) -> None:
    if tile_no < DEV_NOISE_MAX_TILES:
        dev_printf(fmt, *args)

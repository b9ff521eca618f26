"""Tool utilities: Adler-32 pixel checksum + blob IO
(reference tools/misc.hpp:34-86). ako_tpu/tools/misc.py's code, copied
because importing ako_tpu imports JAX."""

from __future__ import annotations

import zlib

import numpy as np


def adler32(data: np.ndarray | bytes) -> int:
    """Pixel checksum printed by the -ch flag (tools/misc.hpp:59-82) —
    standard Adler-32 over the raw bytes."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return zlib.adler32(data, 1) & 0xFFFFFFFF


def write_blob(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:
        f.write(blob)


def read_blob(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()

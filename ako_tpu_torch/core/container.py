"""Container header pack/unpack (wire parity: library/head.c:67-169).

16-byte little-endian header: magic "Ako", format version, width,
height, and a packed flags word (library/ako.h:111-127). The decoder
rejects any flags with bits >= 15 set — the reference's quirk that
caps the *readable* tiles-dimension field at 512 (head.c:124-125) —
which we reproduce for parity.
"""

from __future__ import annotations

import struct
from typing import Tuple

from ako_tpu_torch.core.settings import (
    FORMAT_VERSION,
    AkoError,
    Color,
    Compression,
    Settings,
    Status,
    Wavelet,
    Wrap,
    validate,
)

HEAD_STRUCT = struct.Struct("<3sBIII")
HEAD_SIZE = HEAD_STRUCT.size  # 16
assert HEAD_SIZE == 16


def head_write(channels: int, width: int, height: int, s: Settings) -> bytes:
    # Tiles dimension -> log2 field (min tile is 8 so the field is log2-2)
    binary_tiles_dimension = 0
    if s.tiles_dimension != 0:
        b = s.tiles_dimension
        while b > 1:
            b >>= 1
            binary_tiles_dimension += 1
        if (1 << binary_tiles_dimension) != s.tiles_dimension:
            raise AkoError(Status.INVALID_TILES_DIMENSIONS, "not a power of two")
        binary_tiles_dimension -= 2

    st = validate(
        channels,
        width,
        height,
        s.tiles_dimension,
        s.wrap,
        s.wavelet,
        s.color,
        s.compression,
    )
    if st != Status.OK:
        raise AkoError(st)

    flags = channels - 1
    flags |= int(s.wrap) << 4
    flags |= int(s.wavelet) << 6
    flags |= int(s.color) << 8
    flags |= int(s.compression) << 10
    flags |= binary_tiles_dimension << 12
    return HEAD_STRUCT.pack(b"Ako", FORMAT_VERSION, width, height, flags)


def head_read(blob: bytes) -> Tuple[int, int, int, Settings]:
    """Returns (channels, width, height, settings-from-header)."""
    if len(blob) < HEAD_SIZE:
        raise AkoError(Status.BROKEN_INPUT, "header truncated")
    magic, version, width, height, flags = HEAD_STRUCT.unpack_from(blob)

    if magic != b"Ako":
        raise AkoError(Status.INVALID_MAGIC)
    if version != FORMAT_VERSION:
        raise AkoError(Status.UNSUPPORTED_VERSION)
    if (flags >> 15) != 0:
        raise AkoError(Status.INVALID_FLAGS)

    channels = (flags & 0x000F) + 1
    wrap = Wrap(flags >> 4 & 0x0003)
    wavelet = Wavelet(flags >> 6 & 0x0003)
    color = Color(flags >> 8 & 0x0003)
    compression = Compression(flags >> 10 & 0x0003)

    tiles_dimension = (flags >> 12) & 0x001F
    if tiles_dimension != 0:
        if tiles_dimension < 30:
            tiles_dimension = 1 << (tiles_dimension + 2)
        else:
            raise AkoError(Status.INVALID_TILES_DIMENSIONS)

    st = validate(
        channels, width, height, tiles_dimension, wrap, wavelet, color, compression
    )
    if st != Status.OK:
        raise AkoError(st)

    s = Settings(
        wavelet=wavelet,
        color=color,
        wrap=wrap,
        compression=compression,
        tiles_dimension=tiles_dimension,
    )
    return channels, width, height, s

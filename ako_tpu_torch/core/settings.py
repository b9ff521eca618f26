"""Public settings, enums, limits and status codes.

Behavioral parity with the reference public API surface
(reference library/ako.h:14-99 — enums, limits and the settings
struct; library/misc.c:30-47 — defaults; library/misc.c:71-95 —
status strings). Values of every enum member match the on-disk
format's encoding, since they are packed into the container flags
field (library/ako.h:119-126). A copy of ako_tpu/core/settings.py plus
`from_reference`: importing ako_tpu would import JAX.
"""

from __future__ import annotations

import dataclasses
import enum

VERSION_MAJOR = 0
VERSION_MINOR = 2
VERSION_PATCH = 0

FORMAT_VERSION = 2

MAX_CHANNELS = 16
MAX_WIDTH = 4294967295
MAX_HEIGHT = 4294967295
MIN_TILES_DIMENSION = 8
MAX_TILES_DIMENSION = 2147483648

class Wavelet(enum.IntEnum):
    DD137 = 0
    CDF53 = 1
    HAAR = 2
    NONE = 3


class Color(enum.IntEnum):
    YCOCG = 0
    SUBTRACT_G = 1
    NONE = 2
    YCOCG_Q = 3  # Internal: YCoCg with Y premultiplied x2 for lossy precision


class Wrap(enum.IntEnum):
    CLAMP = 0
    MIRROR = 1
    REPEAT = 2
    ZERO = 3


class Compression(enum.IntEnum):
    KAGARI = 0
    MANBAVARAN = 1  # Reserved in the format, unimplemented (as in reference)
    NONE = 2


class Status(enum.IntEnum):
    OK = 0
    ERROR = 1
    INVALID_CHANNELS_NO = 2
    INVALID_DIMENSIONS = 3
    INVALID_TILES_DIMENSIONS = 4
    INVALID_WRAP_MODE = 5
    INVALID_WAVELET_TRANSFORMATION = 6
    INVALID_COLOR_TRANSFORMATION = 7
    INVALID_COMPRESSION_METHOD = 8
    INVALID_INPUT = 9
    INVALID_CALLBACKS = 10
    INVALID_MAGIC = 11
    UNSUPPORTED_VERSION = 12
    NO_ENOUGH_MEMORY = 13
    INVALID_FLAGS = 14
    BROKEN_INPUT = 15


_STATUS_STRINGS = {
    Status.OK: "Everything Ok!",
    Status.ERROR: "Something went wrong",
    Status.INVALID_CHANNELS_NO: "Invalid channels number",
    Status.INVALID_DIMENSIONS: "Invalid dimensions",
    Status.INVALID_TILES_DIMENSIONS: "Invalid tiles dimensions",
    Status.INVALID_WRAP_MODE: "Invalid wrap mode",
    Status.INVALID_WAVELET_TRANSFORMATION: "Invalid wavelet transformation",
    Status.INVALID_COLOR_TRANSFORMATION: "Invalid color transformation",
    Status.INVALID_COMPRESSION_METHOD: "Invalid compression method",
    Status.INVALID_INPUT: "Invalid input",
    Status.INVALID_CALLBACKS: "Invalid callbacks",
    Status.INVALID_MAGIC: "Invalid magic (not an Ako file)",
    Status.UNSUPPORTED_VERSION: "Unsupported version",
    Status.NO_ENOUGH_MEMORY: "No enough memory",
    Status.INVALID_FLAGS: "Invalid flags",
    Status.BROKEN_INPUT: "Broken input/premature end",
}


def status_string(status: Status) -> str:
    return _STATUS_STRINGS.get(status, "Unknown status code")


class AkoError(Exception):
    """Raised on any encode/decode failure, carrying the Status code."""

    def __init__(self, status: Status, detail: str = ""):
        self.status = Status(status)
        msg = status_string(self.status)
        if detail:
            msg = f"{msg} ({detail})"
        super().__init__(msg)


@dataclasses.dataclass
class Settings:
    wavelet: Wavelet = Wavelet.DD137
    color: Color = Color.YCOCG
    wrap: Wrap = Wrap.CLAMP
    compression: Compression = Compression.KAGARI
    tiles_dimension: int = 0

    quantization: int = 16
    gate: int = 0

    chroma_loss: int = 1
    discard_non_visible: bool = False

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


def default_settings() -> Settings:
    """Defaults matching the reference (library/misc.c:30-47)."""
    return Settings()


def from_reference(obj) -> Settings:
    """The port's Settings from any object with the same field names and
    enum values (an ako_tpu.Settings, for one). Settings is the codec's
    whole carried state: it has no weights, and the per-level q/g
    tables and the blob follow from it and the image."""
    kw = {}
    for f in dataclasses.fields(Settings):
        kind = type(f.default)
        kw[f.name] = kind(int(getattr(obj, f.name)))
    return Settings(**kw)


def validate(
    channels: int,
    width: int,
    height: int,
    tiles_dimension: int,
    wrap: int,
    wavelet: int,
    color: int,
    compression: int,
) -> Status:
    """Shared settings validation (parity: library/head.c:34-64).

    Note the reference accepts channels == 0 here (only the flags
    field arithmetic makes it impossible on the wire).
    """
    # The reference's sValidate accepts channels == 0 (head.c:34-64) but
    # the wire's flags field cannot express it (channels-1 underflows);
    # reject it here rather than letting the header pack raise raw.
    if channels < 1 or channels > MAX_CHANNELS:
        return Status.INVALID_CHANNELS_NO
    if width == 0 or height == 0 or width > MAX_WIDTH or height > MAX_HEIGHT:
        return Status.INVALID_DIMENSIONS
    if tiles_dimension != 0 and (
        tiles_dimension < MIN_TILES_DIMENSION or tiles_dimension > MAX_TILES_DIMENSION
    ):
        return Status.INVALID_TILES_DIMENSIONS
    if wrap not in (Wrap.CLAMP, Wrap.MIRROR, Wrap.REPEAT, Wrap.ZERO):
        return Status.INVALID_WRAP_MODE
    if wavelet not in (Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR, Wavelet.NONE):
        return Status.INVALID_WAVELET_TRANSFORMATION
    if color not in (Color.YCOCG, Color.YCOCG_Q, Color.SUBTRACT_G, Color.NONE):
        return Status.INVALID_COLOR_TRANSFORMATION
    if compression not in (
        Compression.KAGARI,
        Compression.MANBAVARAN,
        Compression.NONE,
    ):
        return Status.INVALID_COMPRESSION_METHOD
    return Status.OK

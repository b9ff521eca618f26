"""The yardstick of the kernels' roofline shares: the card's peaks and the
least bytes and integer operations each function needs, from shapes.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the 32-bit integer rate. Bytes count each input byte
read once and each output byte written once. Operations a value are
counted from each function's plain version, walked a value at a time,
whatever a kernel executes; so a design that adds instructions does not
raise its own bound.
"""

from __future__ import annotations

from portbench.reference import codec as ref

#: NVIDIA H100 SXM device memory, bytes a second (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer lanes of an H100 SXM at its maximum SM clock: 132 SMs x
#: 64 INT32 lanes x 1980 MHz (NVIDIA's Hopper white paper); a constant,
#: not read from the card, so that the yardstick does not move with it
INT32_OPS_PER_S = 132 * 64 * 1980e6
#: operations a sample of one 1-D lifting pass (each sample takes one
#: step: the odd ones the predict, the even ones the update). DD 13/7:
#: the add of the near taps, the x9 multiply, the add of the far taps,
#: the subtract, the truncating /16 or /32 (sign, mask, add, shift: 4)
#: and the add to the sample. CDF 5/3: the add of the taps, the
#: truncating /2 or /4 (4) and the add to the sample
LIFT_OPS = {"DD137": 9, "CDF53": 6}
#: operations a value of Kagari's tokenize and pack (K3): the zigzag and
#: +1 (4), the neighbour compare, the run counter's scan and its flush
#: modulo and tests (8), the literal and token masks (4), two gamma
#: lengths (4), the bit offsets' scan (4) and placing a code's parts in
#: its words (6)
K3_OPS = 30
#: operations a value of the Kagari decode (K4): the window shift and
#: refill, the leading-zero count, the gamma length and value, the
#: unzigzag, the run compare and counters
K4_OPS = 20
#: operations a value of a rate probe's size (K8p): the quantize and gate
#: (8), the neighbour compare (1), the run counter and its flush wrap
#: (4), the literal's test (2), zigzag + 1 (4), the literal's gamma
#: length (2) and the masked add of its bits (2)
K8P_OPS = 23


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3


def stream_values(w: int, h: int, channels: int) -> int:
    """int16 values of one tile's serialized stream (q heads included)."""
    return ref.tile_bytes(w, h, channels) // 2


def tile_shapes(config: dict) -> list:
    """[(w, h)] of every tile of the configuration's image."""
    return [(w, h) for _, _, w, h in ref.tiles(config["width"], config["height"],
                                               config["settings"]["tiles_dimension"])]


def _lift_ops(w: int, h: int, channels: int, wavelet: str) -> int:
    """A tile's lift: per level and channel, the row pass over the plane
    (fake row and column included, 4 x target samples) and the column
    passes over both halves (4 x target)."""
    ops = 0
    for _, _, tw, th in ref.levels_of(w, h):
        name = wavelet if (wavelet != "DD137" or (tw >= 8 and th >= 8)) else "CDF53"
        ops += channels * 8 * tw * th * LIFT_OPS[name]
    return ops


def lift(config: dict) -> float:
    """Bound ms of one image's forward lift (colour, lift, quantize and
    wire order fused): the uint8 image in, the int16 streams out."""
    c, wav = config["channels"], config["settings"]["wavelet"]
    shapes = tile_shapes(config)
    nbytes = config["width"] * config["height"] * c + sum(2 * stream_values(w, h, c)
                                                          for w, h in shapes)
    return bound_ms(nbytes, sum(_lift_ops(w, h, c, wav) for w, h in shapes))


def unlift(config: dict) -> float:
    """Bound ms of one image's inverse: the streams in, uint8 out."""
    return lift(config)


def kagari_encode(config: dict, payload_bytes: int) -> float:
    """Bound ms of K3 on one image: the int16 streams in, the payloads
    that they code to (payload_bytes in all) and a total a tile out."""
    c = config["channels"]
    shapes = tile_shapes(config)
    values = sum(stream_values(w, h, c) for w, h in shapes)
    return bound_ms(2 * values + payload_bytes + 8 * len(shapes), values * K3_OPS)


def kagari_decode(config: dict, payload_bytes: int) -> float:
    """Bound ms of K4 on one image: the payloads in, the streams out."""
    values = sum(stream_values(w, h, config["channels"]) for w, h in tile_shapes(config))
    return bound_ms(payload_bytes + 2 * values, values * K4_OPS)


def rate_sizes(config: dict) -> float:
    """Bound ms of one K8p launch (one probe of the image's tiles, all of
    one shape in the benchmark's configurations): the raw int16 streams
    in, one int64 size a tile out."""
    c = config["channels"]
    shapes = tile_shapes(config)
    values = sum(stream_values(w, h, c) for w, h in shapes)
    return bound_ms(2 * values + 8 * len(shapes), values * K8P_OPS)


def payload_bytes(config: dict, blob: bytes) -> int:
    """The Kagari payload bytes a blob carries: all but the container's
    16-byte head and each tile's 4-byte block head."""
    return len(blob) - 16 - 4 * len(tile_shapes(config))

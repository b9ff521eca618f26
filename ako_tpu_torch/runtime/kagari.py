"""Host-side entropy codec API (native-backed, akort.c).

Byte-level contract: library/kagari.c:228-366 plus the per-tile block
framing of library/compression.c:30-73 (4-byte little-endian
compressed-size head). The device stage produces/consumes the raw int16
coefficient stream; these functions translate it to/from the
container's compressed blocks.

MANBAVARAN: the reference reserves the enum value but ignores it, so a
"manbavaran" blob carries Kagari bytes under the reserved flag; by
default the port writes those parity bytes. With AKO_TPU_MANBAVARAN=1
the reserved method is ako_tpu's static-model rANS coder
(akort.c:akort_manba_encode), as in ako_tpu/runtime/kagari.py. The
decoder reads both: a payload that passes the rANS magic and model
checks decodes as rANS, anything else as Kagari.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ako_tpu_torch.core.settings import Compression
from ako_tpu_torch.runtime.build import load

BLOCK_HEAD = struct.Struct("<I")


def manba_enabled() -> bool:
    return os.environ.get("AKO_TPU_MANBAVARAN") == "1"


def effective_method(method: Compression) -> Compression:
    """The coder actually used inside blocks for a settings-level
    method: KAGARI for the reserved MANBAVARAN unless the extension is
    enabled (the reference always writes Kagari bytes), NONE for raw
    blocks."""
    if method == Compression.MANBAVARAN and manba_enabled():
        return Compression.MANBAVARAN
    return Compression.KAGARI if method != Compression.NONE else method


def manba_encode(values: np.ndarray, output_capacity: int) -> bytes | None:
    """rANS-encode an int16 array (the MANBAVARAN extension's payload);
    None when it won't fit, as kagari_encode. Capacities <= 0 fail up
    front: ctypes would wrap them into a huge size_t."""
    if output_capacity <= 0:
        return None
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.int16)
    out = np.empty(output_capacity, dtype=np.uint8)
    n = lib.akort_manba_encode(
        values.ctypes.data, values.nbytes, out.ctypes.data, output_capacity
    )
    if n == 0:
        return None
    return out[:n].tobytes()


#: Manbavaran payload head: magic 'R', rans byte count, 17 x 12-bit
#: model freqs, final rANS state (wire format at akort.c's coder)
MANBA_HEAD = struct.Struct("<BI17HI")


def manba_assemble(
    freq,
    x_final,
    rans_row: np.ndarray,
    rans_bytes: int,
    extras_row: np.ndarray,
    extras_bits: int,
    ok,
    output_capacity: int,
) -> bytes | None:
    """Frame the device rANS encoder's pieces
    (ops.manba_device.manba_encode_device) into the Manbavaran payload.
    None when the model failed, the device budget truncated a stream,
    or the total exceeds the capacity: the caller then takes the native
    host coder, whose accept/reject boundary is the ground truth (it may
    still succeed when only the device budget was the limit)."""
    if not bool(ok):
        return None
    rans_bytes = int(rans_bytes)
    extras_bytes = (int(extras_bits) + 7) // 8
    total = MANBA_HEAD.size + rans_bytes + extras_bytes
    if (
        total > output_capacity
        or rans_bytes > rans_row.shape[0]
        or extras_bytes > extras_row.shape[0]
    ):
        return None
    head = MANBA_HEAD.pack(
        0x52, rans_bytes, *[int(f) for f in np.asarray(freq)], int(x_final)
    )
    return (
        head
        + np.asarray(rans_row[:rans_bytes]).tobytes()
        + np.asarray(extras_row[:extras_bytes]).tobytes()
    )


def kagari_encode(values: np.ndarray, output_capacity: int) -> bytes | None:
    """Encode an int16 array; None when the stream won't fit (the
    incompressible-tile failure mode, which the orchestrator surfaces
    as Status.ERROR exactly like the reference)."""
    # <= 0 capacities: the reference's pointer arithmetic wraps and its
    # sink bounds fail (every such encode errors); fail up front with
    # the same observable result instead of relying on wrapped pointers
    if output_capacity <= 0:
        return None
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.int16)
    out = np.empty(output_capacity, dtype=np.uint8)
    n = lib.akort_kagari_encode(
        values.ctypes.data, values.nbytes, out.ctypes.data, output_capacity
    )
    if n == 0:
        return None
    return out[:n].tobytes()


def kagari_decode(
    count: int, blob: bytes | memoryview, output_capacity_bytes: int
) -> tuple[np.ndarray, int] | None:
    """Decode `count` int16 values; returns (values, consumed_bytes) or
    None on broken input. `output_capacity_bytes` mirrors the
    reference's slack-tolerant output bound (decode.c:150)."""
    lib = load()
    src = np.frombuffer(blob, dtype=np.uint8)
    out = np.zeros(max(output_capacity_bytes, 2) // 2, dtype=np.int16)
    consumed = lib.akort_kagari_decode(
        count,
        src.ctypes.data if src.size else None,
        src.nbytes,
        out.ctypes.data,
        output_capacity_bytes,
    )
    if consumed == 0:
        return None
    return out[:count], consumed


def kagari_sync(
    count: int,
    blob: bytes | memoryview,
    output_capacity_bytes: int,
    block: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int] | None:
    """Scan a Kagari stream for the device decoder
    (ops/kagari_device.py): one sync record per `block` output values,
    (bit_offsets u32, prev i16, consec u16, run_remaining u16,
    consumed_bytes, max_code_bits). None on broken input; the failure
    conditions are kagari_decode's.

    Streams with max_code_bits > 31 (only through the zigzag(-32768)+1
    wrap quirk) must be decoded on the host: the device decoder's
    window covers codes of at most 31 bits."""
    lib = load()
    src = np.frombuffer(blob, dtype=np.uint8)
    n_rec = (count + block - 1) // block
    bit_off = np.zeros(n_rec, dtype=np.uint32)
    prev = np.zeros(n_rec, dtype=np.int16)
    consec = np.zeros(n_rec, dtype=np.uint16)
    run = np.zeros(n_rec, dtype=np.uint16)
    max_bits = np.zeros(1, dtype=np.uint32)
    consumed = lib.akort_kagari_sync(
        count,
        src.ctypes.data if src.size else None,
        src.nbytes,
        output_capacity_bytes,
        block,
        bit_off.ctypes.data,
        prev.ctypes.data,
        consec.ctypes.data,
        run.ctypes.data,
        max_bits.ctypes.data,
    )
    if consumed == 0:
        return None
    return bit_off, prev, consec, run, consumed, int(max_bits[0])


def manba_sync(count: int, blob: bytes | memoryview, block: int) -> tuple | None:
    """Scan a Manbavaran payload and return per-block sync records for
    the device decoder (ops/manba_device.py): (x u32, rbyte u32, ebit
    u32 arrays, freq (17,) u16, rans_off, rans_end, extras_off,
    consumed). None on anything akort_manba_decode would reject, a
    non-manba payload included: reference-style reserved-flag blobs fail
    the magic check and scan as Kagari."""
    lib = load()
    src = np.frombuffer(blob, dtype=np.uint8)
    n_rec = (count + block - 1) // block
    x = np.zeros(n_rec, dtype=np.uint32)
    rbyte = np.zeros(n_rec, dtype=np.uint32)
    ebit = np.zeros(n_rec, dtype=np.uint32)
    freq = np.zeros(17, dtype=np.uint16)
    offs = np.zeros(3, dtype=np.uint32)
    consumed = lib.akort_manba_sync(
        count,
        src.ctypes.data if src.size else None,
        src.nbytes,
        block,
        x.ctypes.data,
        rbyte.ctypes.data,
        ebit.ctypes.data,
        freq.ctypes.data,
        offs[0:].ctypes.data,
        offs[1:].ctypes.data,
        offs[2:].ctypes.data,
    )
    if consumed == 0:
        return None
    return x, rbyte, ebit, freq, int(offs[0]), int(offs[1]), int(offs[2]), consumed


def manba_decode(count: int, blob: bytes | memoryview) -> np.ndarray | None:
    """Decode `count` int16 values from a rANS (Manbavaran extension)
    payload; None on anything that fails the magic/model/bounds checks
    (the caller then falls back to Kagari for reserved-flag blobs)."""
    lib = load()
    src = np.frombuffer(blob, dtype=np.uint8)
    out = np.zeros(max(count, 1), dtype=np.int16)
    consumed = lib.akort_manba_decode(
        count,
        src.ctypes.data if src.size else None,
        src.nbytes,
        out.ctypes.data,
        out.nbytes,
    )
    if consumed == 0:
        return None
    return out[:count]


def compress_block(
    values: np.ndarray,
    tile_data_size: int,
    method: Compression = Compression.KAGARI,
) -> bytes | None:
    """Entropy payload + 4-byte block head (compression.c:36-55). The
    output budget equals the uncompressed tile size — incompressible
    tiles fail, as in the reference. `method` selects the coder through
    effective_method (MANBAVARAN is rANS only under the extension)."""
    if effective_method(method) == Compression.MANBAVARAN:
        payload = manba_encode(values, tile_data_size - BLOCK_HEAD.size)
    else:
        payload = kagari_encode(values, tile_data_size - BLOCK_HEAD.size)
    if payload is None:
        return None
    return BLOCK_HEAD.pack(len(payload)) + payload


def decompress_block(
    blob: memoryview,
    tile_data_size: int,
    output_capacity_bytes: int,
    method: Compression = Compression.KAGARI,
) -> tuple[np.ndarray, int] | None:
    """Inverse of compress_block (compression.c:58-73); returns
    (values, total_consumed_incl_head) or None on broken input. A
    MANBAVARAN-flagged block is tried as a rANS payload first."""
    if len(blob) < BLOCK_HEAD.size:
        return None
    (block_size,) = BLOCK_HEAD.unpack_from(blob)
    payload = blob[BLOCK_HEAD.size : BLOCK_HEAD.size + block_size]
    if len(payload) < block_size:
        return None
    count = tile_data_size // 2
    if method == Compression.MANBAVARAN:
        values = manba_decode(count, payload)
        if values is not None:
            return values, block_size + BLOCK_HEAD.size
    res = kagari_decode(count, payload, output_capacity_bytes)
    if res is None:
        return None
    values, consumed = res
    if consumed != block_size:
        return None
    return values, block_size + BLOCK_HEAD.size

"""The rate search's device programs (K8): the counterpart of the XLA
programs of ako_tpu/tools/rate.py.

ako_tpu computes a colour variant's unquantized lift pyramid once and
re-runs only the quantize/gate and the Kagari sizing at each probe's q
(rate.py:9-15). Here the cached pyramid is a (T, n) int16 stream in wire
order: ops/lifting.forward_tiles at the identity table of identity_qg
(q = 1, g = 0 for every level and channel), which leaves every coefficient
as it is and writes heads of 1 (the quantizer divides by max(q, 1)). A
probe's per-(level, channel) q and g, `qs` and `gs` ((levels, channels)
int16, as ako_tpu passes them), then map position p of a row to
  in the LP region            its raw value;
  at a (level, channel) head  int16(q);
  elsewhere                   _quantize_gate(x, q, g) (lifting.c:154-168).

- rate_serialize: that map, as (T, n) int16 streams (ako_tpu's
  _serialize_fn, rate.py:82). On a CUDA tensor kernel K8s
  (csrc/rate.cu), one launch of a grid sized to the card.
- rate_sizes: each row's exact Kagari payload bytes at the probe, one
  int64 a row and nothing else (ako_tpu's _probe_sizes_fn, rate.py:101).
  On a CUDA tensor kernel K8p (csrc/rate.cu): each row cut into spans
  (span_cut), each span's bits from its first mismatch on by a CTA, and
  the positions before each span's first mismatch added in closed form
  (run_bits) by the CTA that counts the row's last span in.

A CPU tensor takes the plain versions (serialize_plain, probe_sizes_plain:
torch ops), which the card's checks hold the kernels to; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ako_tpu_torch.core.geometry import LiftSchedule
from ako_tpu_torch.ops.kagari_device import FLUSH_COUNTER, kagari_size_device, take_scratch
from ako_tpu_torch.ops.lift_kernels import _quantize_gate, level_offsets
from ako_tpu_torch.runtime import kernels

#: kernel launches per wrapper (one per call that reaches the card)
LAUNCHES = {"rate_serialize": 0, "rate_sizes": 0}


def identity_qg(schedule: LiftSchedule, channels: int) -> list:
    """The q/g table (level_qg's form) at which forward_tiles writes the
    raw pyramid: q = 1, g = 0 for every level and channel."""
    return [((1,) * channels, (0,) * channels)] * len(schedule.levels)


def probe_qg(qg, channels: int) -> tuple:
    """level_qg's per-level ((q per channel), (g per channel)) as the
    (qs, gs) (levels, channels) int16 arrays of a probe, as ako_tpu's
    encode_at and size_at make them (level_qg's values stay below 2^15)."""
    qs = np.asarray([list(q) for q, _ in qg], np.int16).reshape(len(qg), channels)
    gs = np.asarray([list(g) for _, g in qg], np.int16).reshape(len(qg), channels)
    return qs, gs


@functools.lru_cache(maxsize=256)
def segments(schedule: LiftSchedule, channels: int) -> tuple:
    """(lp, starts, lengths, index) of a stream: the LP region's length,
    and per (level, channel) segment in wire order (levels smallest first)
    its first position (the q head), its length, and its (level, channel)
    as the row-major index level * channels + channel of a (qs, gs)
    table."""
    offs = level_offsets(schedule, channels)
    starts, lengths, index = [], [], []
    for k in reversed(range(len(schedule.levels))):
        lvl = schedule.levels[k]
        seg = 1 + 3 * lvl.target_h * lvl.target_w
        for c in range(channels):
            starts.append(offs[k] + c * seg)
            lengths.append(seg)
            index.append(k * channels + c)
    return channels * schedule.lp_h * schedule.lp_w, tuple(starts), tuple(lengths), tuple(index)


def _checked_qg(schedule: LiftSchedule, channels: int, qs, gs) -> tuple:
    qs, gs = np.asarray(qs, np.int16), np.asarray(gs, np.int16)
    want = (len(schedule.levels), channels)
    if qs.shape != want or gs.shape != want:
        raise ValueError(f"rate: q/g tables {qs.shape} {gs.shape}, expected {want}")
    return qs, gs


def serialize_plain(raw, schedule: LiftSchedule, channels: int, qs, gs):
    """The plain version of rate_serialize: torch ops on raw's device. The
    LP region keeps q = 1, g = -1, which _quantize_gate leaves as it is."""
    qs, gs = _checked_qg(schedule, channels, qs, gs)
    lp, starts, lengths, index = segments(schedule, channels)
    q_seg = [1] + [int(qs.flat[i]) for i in index]
    g_seg = [-1] + [int(gs.flat[i]) for i in index]
    lens = torch.tensor([lp, *lengths], device=raw.device)
    q = torch.repeat_interleave(torch.tensor(q_seg, dtype=torch.int32, device=raw.device), lens)
    g = torch.repeat_interleave(torch.tensor(g_seg, dtype=torch.int32, device=raw.device), lens)
    out = _quantize_gate(raw, q, g)
    if starts:
        out[:, torch.tensor(starts, device=raw.device)] = torch.tensor(
            q_seg[1:], dtype=torch.int16, device=raw.device)
    return out


def probe_sizes_plain(raw, schedule: LiftSchedule, channels: int, qs, gs):
    """The plain version of rate_sizes: serialize_plain, then the plain
    tokenizer's code lengths (kagari_device.kagari_size_device)."""
    return kagari_size_device(serialize_plain(raw, schedule, channels, qs, gs))


@functools.lru_cache(maxsize=1024)
def _rate_args(schedule: LiftSchedule, channels: int, qs: bytes, gs: bytes) -> kernels.RateArgs:
    lp, starts, lengths, index = segments(schedule, channels)
    if len(starts) > kernels.MAX_RATE_SEGS:
        raise ValueError(f"rate: {len(starts)} (level, channel) segments, the kernels take "
                         f"{kernels.MAX_RATE_SEGS}")
    q = np.frombuffer(qs, np.int16)
    g = np.frombuffer(gs, np.int16)
    a = kernels.RateArgs()
    a.n, a.lp, a.segs = schedule.coeff_count(channels), lp, len(starts)
    a.start[: len(starts)] = starts
    a.q[: len(starts)] = [int(q[i]) for i in index]
    a.g[: len(starts)] = [int(g[i]) for i in index]
    return a


def rate_args(schedule: LiftSchedule, channels: int, qs, gs) -> kernels.RateArgs:
    """The kernels' table of a probe (csrc/rate_common.cuh RateArgs),
    cached: a search asks for the same q again at its end."""
    qs, gs = _checked_qg(schedule, channels, qs, gs)
    return _rate_args(schedule, channels, qs.tobytes(), gs.tobytes())


def _checked_raw(name: str, raw, schedule: LiftSchedule, channels: int):
    if raw.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {raw.device}")
    n = schedule.coeff_count(channels)
    if raw.dtype != torch.int16 or raw.dim() != 2 or raw.shape[1] != n or not raw.is_contiguous():
        raise ValueError(f"{name}: expected contiguous int16 (T, {n}) raw streams, got "
                         f"{raw.dtype} {tuple(raw.shape)}")


def rate_serialize(raw, schedule: LiftSchedule, channels: int, qs, gs):
    """(T, n) int16 raw streams -> (T, n) int16 streams at the probe's qs,
    gs. A CUDA tensor launches K8s once; a CPU tensor takes
    serialize_plain."""
    if raw.device.type == "cpu":
        return serialize_plain(raw, schedule, channels, qs, gs)
    _checked_raw("rate_serialize", raw, schedule, channels)
    args = rate_args(schedule, channels, qs, gs)
    out = torch.empty_like(raw)
    if raw.shape[0]:
        with torch.cuda.device(raw.device):
            kernels.rate_serialize(raw.data_ptr(), out.data_ptr(), raw.shape[0], args,
                                   torch.cuda.current_stream().cuda_stream)
        kernels.count_launch(LAUNCHES, "rate_serialize")
    return out


def span_cut(rows: int, n: int, ctas: int) -> tuple:
    """(spans a row, span length) of a K8p or K8s launch over `rows` rows
    of n values on a grid of `ctas` CTAs (csrc/rate_common.cuh span_cut):
    span 0 is [0, o + len), span k [o + k len, o + (k + 1) len), the last
    ending at n, where o is the row's origin (span_bounds) and len a
    multiple of 16; the most spans with spans * rows <= ctas (at least one
    a row) that leave the last one non-empty."""
    want = ctas // rows if rows < ctas else 1
    length = (-(-n // want) + 15) // 16 * 16
    return (-(-(n - 7) // length) if n > 7 else 1), length


def span_bounds(row: int, k: int, n: int, cut: tuple, mis: int = 0) -> tuple:
    """(begin, end, origin) of span k of `row` (csrc/rate_common.cuh
    span_of), for rows at an int16 offset `mis` from a 16-byte boundary:
    the row's origin o is 0 where the row starts on 16 bytes, else 8
    values before its first 16-byte-aligned position; a span's origin is
    its begin, the first span's o."""
    spr, length = cut
    al = (8 - (mis + row * n) % 8) % 8
    o = al - 8 if al else 0
    begin = o + k * length if k else 0
    end = n if k == spr - 1 else o + (k + 1) * length
    return begin, end, (begin if k else o)


def lit_len(v: int) -> int:
    """Bits of the Elias-gamma literal of value v: zigzag(v) + 1 mod 2^16."""
    return 2 * ((abs(v) & 0x7FFF).bit_length() - 1) + 3


def run_bits(m: int, a: int, b: int, v: int, ends: bool) -> int:
    """Bits of positions [a, b] of a run of value v that starts at mismatch
    m < a (csrc/rate.cu run_bits): with d = p - m and the run counter
    rc = (d - 1) % 65534 + 1, a literal where rc <= 2, a flush token
    (gamma(65533), 31 bits) where rc == 65534, and, when the run ends at b,
    the end token gamma(rc - 1) there if rc >= 2 and b is no flush."""
    k = FLUSH_COUNTER
    d0, d1 = a - 1 - m, b - m
    lits = 2 * (d1 // k) + min(d1 % k, 2) - 2 * (d0 // k) - min(d0 % k, 2)
    bits = lits * lit_len(v) + 31 * (d1 // k - d0 // k)
    rc = (d1 - 1) % k + 1
    if ends and 2 <= rc != k:
        bits += 2 * ((rc - 1).bit_length() - 1) + 1
    return bits


def sizes_scratch_words(rows: int, spans: int) -> int:
    """64-bit words of K8p's scratch for up to `rows` rows and `spans`
    spans (csrc/rate.cu ako_rate_sizes): a 16-byte record a span, then a
    32-bit counter a row."""
    return 2 * spans + (rows + 1) // 2


def rate_sizes(raw, schedule: LiftSchedule, channels: int, qs, gs):
    """(T, n) int16 raw streams -> (T,) int64 exact Kagari payload bytes
    at the probe's qs, gs. A CUDA tensor launches K8p once, over a scratch
    kept per device and stream (kagari_device.encode_scratch, K8p's own
    layout); a CPU tensor takes probe_sizes_plain."""
    if raw.device.type == "cpu":
        return probe_sizes_plain(raw, schedule, channels, qs, gs)
    _checked_raw("rate_sizes", raw, schedule, channels)
    args = rate_args(schedule, channels, qs, gs)
    rows = raw.shape[0]
    sizes = torch.empty((rows,), dtype=torch.int64, device=raw.device)
    if rows:
        with torch.cuda.device(raw.device):
            ctas = kernels.rate_sizes_ctas()  # asked once a device on the C side
            stream = torch.cuda.current_stream().cuda_stream
            scratch, rows_cap, spans_cap, _ = take_scratch(raw.device, stream, rows,
                                                           max(rows, ctas), sizes_scratch_words)
            kernels.rate_sizes(raw.data_ptr(), sizes.data_ptr(), scratch.data_ptr(),
                               scratch.numel(), rows_cap, spans_cap, rows, args, stream)
        kernels.count_launch(LAUNCHES, "rate_sizes")
    return sizes

"""Manbavaran (static-model rANS) coding on the device: the counterpart
of ako_tpu/ops/manba_device.py, for the MANBAVARAN extension
(AKO_TPU_MANBAVARAN=1; wire format at csrc/akort.c's coder).

  encode (manba_encode_device)
    Each value's code is (u16)(zigzag(v) + 1), 0 standing for 65536; its
    symbol is the code's bit length - 1 (0..16) and its extra the code's
    low `sym` bits (sym_extra). A tile's 17-bin histogram gives the
    12-bit model (manba_model); the symbols are rANS-coded back to front
    (32-bit state, 8-bit renorm), which is one serial chain per tile
    stream, and the extras are bit-packed MSB first in symbol order at
    offsets from an exclusive scan of the symbols.
    On a CUDA tensor this is kernel K6e (csrc/manba_encode.cu, three
    launches a call: symbols and histograms per chunk, the model and the
    extras' chunk offsets per tile, then the chains beside the extras
    pack). A CPU tensor takes the plain version (manba_encode_plain),
    which is also what K6e is checked against on the card.
  decode (manba_decode_device)
    A host scan (runtime.kagari.manba_sync) gives each block of
    DECODE_BLOCK outputs its rANS state and its two read positions (the
    rANS bytes and the extras bits), so every (tile, block) lane decodes
    on its own. On a CUDA tensor that is kernel K6d
    (csrc/manba_decode.cu); a CPU tensor takes the plain version.

The encoder returns one small int32 record per tile (RECORD columns:
the 17 frequencies, the final state, the rANS byte count, the extras
bit count and ok) and two rows of `budget` bytes: the rANS bytes in
stream order at the END of their row (the chain writes them downward as
it emits them), the extras from the start of theirs. The host frames a
payload from those (runtime.kagari.manba_assemble) and hands a tile to
the native coder when it does not fit, as ako_tpu does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ako_tpu_torch.ops.kagari_device import DECODE_BLOCK, pack_bits
from ako_tpu_torch.runtime import kernels

SYMS = 17
PROB_BITS = 12
PROB_SCALE = 1 << PROB_BITS
STATE_LO = 1 << 23
_U32 = 0xFFFFFFFF

#: columns of the encoder's per-tile int32 record
RECORD = {"freq": slice(0, SYMS), "x": SYMS, "rans_bytes": SYMS + 1, "extras_bits": SYMS + 2,
          "ok": SYMS + 3}
RECORD_WORDS = SYMS + 4

#: values per chunk of kernel K6e (csrc/manba_encode.cu kChunk), and
#: int32 words of its scratch per chunk (17 bin counts, the chunk's
#: extras bits, its extras bit offset)
K6_CHUNK = 4096
K6_SCRATCH = SYMS + 2

#: the most pool words K6d takes: its word cursors and limits are 32-bit
#: (csrc/manba_decode.cu launch_decode)
K6D_MAX_POOL_WORDS = 2**31 - 5

#: kernel launches per wrapper (one per call that reaches the card)
LAUNCHES = {"manba_encode": 0, "manba_decode": 0}


def sym_extra(values):
    """(..., n) int16 -> (sym 0..16, extra, code) int64: the code
    (u16)(zigzag(v) + 1) in 1..65536 (0 stands for 65536, so -32768
    gets sym 16 and 16 extra bits), sym its bit length - 1 and extra its
    low sym bits (akort.c manba_sym)."""
    v = values.to(torch.int64)
    z = ((v << 1) ^ (v >> 15)) & 0xFFFF
    m = (z + 1) & 0xFFFF
    code = torch.where(m == 0, 65536, m)
    # the float32 exponent of a value below 2^17 is exact
    _, e = torch.frexp(code.to(torch.float32))
    sym = e.to(torch.int64) - 1
    return sym, code - (1 << sym), code


def manba_model(sym, n: int):
    """The 12-bit static model of akort.c manba_model for (..., n)
    symbols: (freq (..., 17) int64, ok (...) bool). floor(hist * 4096 /
    n) in 64 bits, a present symbol with 0 bumped to 1, and the drift
    settled on the first maximum after the bumps (a strict-greater scan
    from index 0, which torch.argmax's first index is). ok is False when
    that frequency would fall below 1."""
    hist = torch.zeros(sym.shape[:-1] + (SYMS,), dtype=torch.int64, device=sym.device)
    hist.scatter_add_(-1, sym.to(torch.int64), torch.ones_like(sym, dtype=torch.int64))
    f = (hist << PROB_BITS) // max(n, 1)
    f = torch.where((hist > 0) & (f == 0), 1, f)
    maxi = torch.argmax(f, dim=-1, keepdim=True)
    fixed = f.gather(-1, maxi) + (PROB_SCALE - f.sum(-1, keepdim=True))
    f = f.scatter(-1, maxi, fixed.clamp(min=1))
    return f, (fixed >= 1).squeeze(-1)


def manba_encode_plain(values, budget_bytes: int):
    """The plain version of K6e (torch ops): (..., n) int16 streams ->
    (record (..., RECORD_WORDS) int32, rans (..., budget) u8, extras
    (..., budget) u8), laid out as manba_encode_device's. The chain is a
    loop over positions, vectorised over the streams."""
    batch, n = tuple(values.shape[:-1]), values.shape[-1]
    v = values.reshape(-1, n)
    rows, dev = v.shape[0], v.device
    sym, extra, _ = sym_extra(v)
    freq, ok = manba_model(sym, n)
    cum = torch.cumsum(freq, dim=-1) - freq
    # per position, in chain order (back to front), one row per step
    f = freq.gather(1, sym).clamp(min=1).flip(1).T.contiguous()
    c = cum.gather(1, sym).flip(1).T.contiguous()
    xmax = f << 19  # (STATE_LO >> PROB_BITS) << 8
    xmax8 = xmax << 8
    gain = PROB_SCALE - f
    x = torch.full((rows,), STATE_LO, dtype=torch.int64, device=dev)
    xs = torch.empty((n, rows), dtype=torch.int64, device=dev)
    for i in range(n):
        xs[i] = x
        k = (x >= xmax[i]).to(torch.int64) + (x >= xmax8[i])
        x = x >> (8 * k)
        # (x / f << 12) + x % f + cum == x + (x / f) * (4096 - f) + cum
        x = x + torch.div(x, f[i], rounding_mode="floor") * gain[i] + c[i]
    # emissions in chain order, b0 before b1 within a step; the rANS
    # bytes are their reverse, written downward from the row's end
    k = ((xs >= xmax).to(torch.int64) + (xs >= xmax8)).T
    xs = xs.T
    em = torch.stack([k >= 1, k >= 2], dim=-1).reshape(rows, 2 * n)
    by = torch.stack([xs & 0xFF, (xs >> 8) & 0xFF], dim=-1).reshape(rows, 2 * n)
    rank = torch.cumsum(em, dim=1) - 1
    rbytes = em.sum(dim=1)
    pos = budget_bytes - 1 - rank
    keep = em & (pos >= 0)
    rans = torch.zeros((rows, budget_bytes), dtype=torch.uint8, device=dev)
    flat = (torch.arange(rows, device=dev)[:, None] * budget_bytes + pos)[keep]
    rans.view(-1)[flat] = by[keep].to(torch.uint8)
    extras, ebits = pack_bits(extra, sym, budget_bytes)
    record = torch.cat([freq, x[:, None], rbytes[:, None], ebits[:, None], ok[:, None]], dim=1)
    return (record.to(torch.int32).reshape(batch + (RECORD_WORDS,)),
            rans.reshape(batch + (budget_bytes,)), extras.reshape(batch + (budget_bytes,)))


def unpack_record(record) -> tuple:
    """A (..., RECORD_WORDS) record (numpy or torch) -> (freq (..., 17),
    x, rans_bytes, extras_bits, ok) as numpy: freq int64, the rest int64
    but ok bool."""
    r = np.asarray(record.cpu() if isinstance(record, torch.Tensor) else record).astype(np.int64)
    return (r[..., RECORD["freq"]], r[..., RECORD["x"]], r[..., RECORD["rans_bytes"]],
            r[..., RECORD["extras_bits"]], r[..., RECORD["ok"]] != 0)


def manba_encode_device(values, budget_bytes: int):
    """Manbavaran encode of (..., n) int16 streams. Returns (record
    (..., RECORD_WORDS) int32, rans (..., budget_bytes) u8, extras (...,
    budget_bytes) u8).

    The record's counts are exact whatever the budget: a tile whose rANS
    bytes or extras do not fit in budget_bytes has its rows cut, and its
    caller hands it to the host coder. The rANS row holds the last
    min(rans_bytes, budget) bytes of the stream at its end (the first
    ones the chain emits); ako_tpu's holds the first ones at its start.

    A CUDA tensor launches kernel K6e (three launches); a CPU tensor
    takes the plain version."""
    if values.device.type == "cpu":
        return manba_encode_plain(values, budget_bytes)
    if values.device.type != "cuda":
        raise ValueError(f"manba_encode_device: no kernel for device {values.device}")
    n = values.shape[-1] if values.dim() else 0
    if values.dtype != torch.int16 or n == 0 or not values.is_contiguous():
        raise ValueError("manba_encode_device: expected contiguous int16 (..., n) streams, n > 0, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if budget_bytes < 1:
        raise ValueError(f"manba_encode_device: budget {budget_bytes} bytes")
    batch = tuple(values.shape[:-1])
    rows = math.prod(batch)
    row_words = -(-budget_bytes // 4)
    dev = values.device
    record = torch.empty((rows, RECORD_WORDS), dtype=torch.int32, device=dev)
    rans = torch.empty((rows, budget_bytes), dtype=torch.uint8, device=dev)
    extras = torch.empty((rows, 4 * row_words), dtype=torch.uint8, device=dev)
    if rows:
        scratch = torch.empty((rows * -(-n // K6_CHUNK) * K6_SCRATCH,), dtype=torch.int32,
                              device=dev)
        with torch.cuda.device(dev):
            kernels.manba_encode(values.data_ptr(), record.data_ptr(), scratch.data_ptr(),
                                 rans.data_ptr(), extras.data_ptr(), rows, n, budget_bytes,
                                 row_words, torch.cuda.current_stream().cuda_stream)
        kernels.count_launch(LAUNCHES, "manba_encode")
    return (record.reshape(batch + (RECORD_WORDS,)), rans.reshape(batch + (budget_bytes,)),
            extras[:, :budget_bytes].reshape(batch + (budget_bytes,)))


# ---------------------------------------------------------------------
# Decode


def span_words(byte_or_bit_offsets, end, bits: bool, slack: int = 3) -> int:
    """Most 32-bit words any block's window touches, from consecutive
    sync offsets (byte offsets when bits=False) and the region's end,
    plus `slack`: the plain decoder's window width for the rANS bytes
    and for the extras bits."""
    off = np.asarray(byte_or_bit_offsets, np.int64)
    if not bits:
        off = off * 8
        end = end * 8
    if off.size == 0:
        return slack
    ends = np.concatenate([off[1:], np.asarray([max(int(end), 1)], np.int64)])
    spans = (np.maximum(ends, off + 1) - 1) // 32 - off // 32 + 1
    return int(spans.max()) + slack


def _unzigzag(code):
    q = (code - 1) & 0xFFFF
    x = ((q >> 1) ^ ((q & 1) * 0xFFFF)) & 0xFFFF
    return x - ((x & 0x8000) << 1)


def manba_decode_plain(pool, base, rans_end, extras_off, x, rbyte, ebit, freq, n_outputs: int,
                       block: int = DECODE_BLOCK, rspan: int | None = None,
                       espan: int | None = None):
    """The plain version of K6d: all (tile, block) lanes at once for
    `block` steps, each lane reading two windows of the pool (`rspan`
    and `espan` words wide, span_words; None = the whole pool), as
    ako_tpu/ops/manba_device.py manba_decode_device."""
    T, B = x.shape
    W = pool.shape[0]
    dev = pool.device
    rspan = W if rspan is None else max(3, min(rspan, W))
    espan = W if espan is None else max(3, min(espan, W))
    words = pool.to(torch.int64) & _U32
    base_bits = base.to(torch.int64).repeat_interleave(B) * 32
    rb = rbyte.to(torch.int64).reshape(-1) & _U32
    rbits = base_bits + rb * 8
    ebits = (base_bits + (extras_off.to(torch.int64) & _U32).repeat_interleave(B) * 8
             + (ebit.to(torch.int64).reshape(-1) & _U32))
    rrem = (rans_end.to(torch.int64) & _U32).repeat_interleave(B) - rb
    xs = x.to(torch.int64).reshape(-1) & _U32
    fr = freq.to(torch.int64).repeat_interleave(B, dim=0)
    cum = torch.cumsum(fr, dim=1) - fr
    ends = cum + fr

    def window(bits, span):
        cols = torch.arange(span, device=dev)
        return words[((bits >> 5)[:, None] + cols).clamp(0, W - 1)], bits & 31

    def top32(win, pos):
        w = pos >> 5
        sh = pos & 31
        hi = win.gather(1, w[:, None].clamp(max=win.shape[1] - 1))[:, 0]
        lo = win.gather(1, (w[:, None] + 1).clamp(max=win.shape[1] - 1))[:, 0]
        return ((hi << sh) | (lo >> (32 - sh))) & _U32

    rwin, rpos = window(rbits, rspan)
    ewin, epos = window(ebits, espan)
    out = []
    for _ in range(block):
        slot = xs & (PROB_SCALE - 1)
        sym = (ends[:, : SYMS - 1] <= slot[:, None]).sum(dim=1, keepdim=True)
        xs = fr.gather(1, sym)[:, 0] * (xs >> PROB_BITS) + slot - cum.gather(1, sym)[:, 0]
        top = top32(rwin, rpos)
        for b in range(2):
            need = (xs < STATE_LO) & (rrem > 0)
            xs = torch.where(need, (xs << 8) | ((top >> (24 - 8 * b)) & 0xFF), xs)
            rpos = rpos + 8 * need
            rrem = rrem - need.to(torch.int64)
        sym = sym[:, 0]
        extra = torch.where(sym > 0, top32(ewin, epos) >> (32 - sym), 0)
        epos = epos + sym
        out.append(_unzigzag((1 << sym) + extra))
    ys = torch.stack(out, dim=-1).reshape(T, B * block)[:, :n_outputs]
    return ys.to(torch.int16)


def manba_decode_device(pool, base, rans_end, extras_off, x, rbyte, ebit, freq, n_outputs: int,
                        block: int = DECODE_BLOCK, rspan: int | None = None,
                        espan: int | None = None):
    """Block-parallel Manbavaran decode of T tiles' payloads.

    pool: (W,) int32, every tile's payload as big-endian 32-bit words
    (bit patterns), word-aligned at the tile's `base` (T,), with
    DECODE_SLACK_WORDS zero words after the last. rans_end, extras_off:
    (T,) byte offsets in the payload; x, rbyte, ebit: (T, B) sync
    records (runtime.kagari.manba_sync, u32 bit patterns), B =
    ceil(n_outputs / block); freq: (T, 17). All int32. Returns (T,
    n_outputs) int16, bit-exact with akort_manba_decode.

    A CUDA tensor launches kernel K6d (block must be DECODE_BLOCK, the
    pool at most K6D_MAX_POOL_WORDS words; the windows are read from the
    pool and `rspan`/`espan` are ignored); a CPU tensor takes the plain
    version."""
    T, B = x.shape
    if pool.device.type == "cpu":
        return manba_decode_plain(pool, base, rans_end, extras_off, x, rbyte, ebit, freq,
                                  n_outputs, block, rspan, espan)
    if pool.device.type != "cuda":
        raise ValueError(f"manba_decode_device: no kernel for device {pool.device}")
    if block != DECODE_BLOCK:
        raise ValueError(f"manba_decode_device: the kernel decodes blocks of {DECODE_BLOCK}, "
                         f"not {block}")
    if B != -(-n_outputs // block):
        raise ValueError(f"manba_decode_device: {B} sync records for {n_outputs} outputs")
    if not 1 <= pool.shape[0] <= K6D_MAX_POOL_WORDS:
        raise ValueError(f"manba_decode_device: a pool of {pool.shape[0]} words; the kernel's "
                         f"32-bit word cursors take 1 to {K6D_MAX_POOL_WORDS}")
    for name, t, shape in (("pool", pool, (pool.shape[0],)), ("base", base, (T,)),
                           ("rans_end", rans_end, (T,)), ("extras_off", extras_off, (T,)),
                           ("x", x, (T, B)), ("rbyte", rbyte, (T, B)), ("ebit", ebit, (T, B)),
                           ("freq", freq, (T, SYMS))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"manba_decode_device: {name} must be contiguous int32 {shape}")
        if t.device != pool.device:
            raise ValueError(f"manba_decode_device: {name} is not on {pool.device}")
    out = torch.empty((T, n_outputs), dtype=torch.int16, device=pool.device)
    if T:
        with torch.cuda.device(pool.device):
            kernels.manba_decode(pool.data_ptr(), pool.shape[0], base.data_ptr(),
                                 rans_end.data_ptr(), extras_off.data_ptr(), x.data_ptr(),
                                 rbyte.data_ptr(), ebit.data_ptr(), freq.data_ptr(),
                                 out.data_ptr(), T, B, n_outputs,
                                 torch.cuda.current_stream().cuda_stream)
        kernels.count_launch(LAUNCHES, "manba_decode")
    return out

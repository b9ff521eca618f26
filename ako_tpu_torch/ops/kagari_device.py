"""Kagari entropy coding on the device: the counterpart of
ako_tpu/ops/kagari_device.py.

The reference coder is a sequential bit-accumulator loop
(library/kagari.c:59-366). On the device it becomes data-parallel
passes over whole coefficient streams, batched over a leading tile
dimension:

  encode
    On a CUDA tensor this is kernel K3 (csrc/kagari_encode.cu), one
    launch a call: each chunk of K3_CHUNK positions of a stream is one
    CTA, which takes the last mismatch and the bit offset of its stream's
    earlier chunks by decoupled look-back over descriptors in a scratch
    the wrapper keeps per device and stream (encode_scratch), tokenizes,
    and packs its codes. The plain version below (torch ops on int32/int64;
    torch's uint32 lacks shifts and compares on the CPU) is what a CPU
    tensor takes and what K3 is checked against on the card:
    1. zigzag + RLE tokenization: the run structure comes from a
       cumulative max of the last mismatch, and the run-length escape
       rules (trigger 2, forced flush at counter 65534) are evaluated
       pointwise from that distance;
    2. Elias-gamma code lengths and their exclusive cumsum (bit
       offsets);
    3. every code splits into at most two parts, in its own 32-bit word
       and the next; the parts of one word hold disjoint bits, so an
       integer index_add_ of the parts is their OR, in any order;
    4. big-endian bytes.
  decode
    A host scan (runtime.kagari.kagari_sync) gives each block of
    DECODE_BLOCK outputs its bit offset and carry state, so every
    (tile, block) lane decodes on its own. On a CUDA tensor that is
    kernel K4 (csrc/kagari_decode.cu: K4_LANES lanes of a tile per CTA,
    their words staged in shared memory, decode_cta_spans); the plain
    version below runs all lanes at once for `block` steps and is what
    a CPU tensor takes and what K4 is checked against on the card.

The bytes equal the reference coder's exactly; only its failure
conditions differ, so callers hand tiles near the capacity to the host
coder (encode.py). The TPU-only scatter-free packers of ako_tpu (rank,
placement and MXU cumsums) are not ported.
"""

from __future__ import annotations

import math
import threading

import numpy as np
import torch

from ako_tpu_torch.runtime import kernels

RLE_TRIGGER = 2
VALUE_MAX = 65535
FLUSH_COUNTER = VALUE_MAX - 1  # run counter value that forces a token

#: sync-record consec sentinel: "first output of the stream pending"
#: (the reference writes the first literal without any run comparison,
#: kagari.c:322; akort_kagari_sync emits the same sentinel)
SYNC_FIRST = 0xFFFF

#: outputs decoded per device block, each from its own host sync record
DECODE_BLOCK = 128

#: word-pool slack callers pad beyond the compressed bytes, so the
#: window's two-word prefetch never reads past the pool
DECODE_SLACK_WORDS = 2

_U32 = 0xFFFFFFFF

#: chunk width of the two-level running max in _run_lengths
_SCAN_CHUNK = 1024

#: per-row spill slots of pack_bits for the parts that carry no bits
#: or fall past the capacity; spreading them over many addresses keeps
#: the atomic adds of a long run off one word
_SPILL_SLOTS = 1024

#: positions per CTA of kernel K3 (csrc/kagari_encode.cu kChunk)
K3_CHUNK = 4096

#: K3's descriptor epochs run 1 .. K3_EPOCHS - 1; the scratch is made
#: anew when they run out
K3_EPOCHS = 1 << 31

#: kernel K4's CTA: lanes (threads) of one tile, and the most pool words
#: it stages in shared memory (csrc/kagari_decode.cu kLanes, kSpanWords)
K4_LANES = 64
K4_SPAN_WORDS = 4096

#: kernel launches per wrapper (one per call that reaches the card)
LAUNCHES = {"kagari_encode": 0, "kagari_decode": 0}

#: K3's scratch per (device index, stream): [int64 tensor, rows it
#: holds, chunks it holds, last epoch]; _SCRATCH_LOCK guards its
#: get-or-create and the epoch a call takes, since the executor launches
#: from two threads at once
_SCRATCH: dict = {}
_SCRATCH_LOCK = threading.RLock()


def _exclusive_cumsum(x):
    return torch.cumsum(x, dim=-1) - x


def _run_lengths(same):
    """same: (..., n) bool, position i equal to position i-1 (never at
    i = 0). Returns int32 (..., n): the distance from each position to
    the last position at or before it that is not `same`.

    A running max of the mismatch indices, over all rows at once with
    global indices (each row starts with a mismatch, so no row sees the
    one before it), taken in chunks and then carried across chunks: a
    scan along one long row runs on a single thread block."""
    flat = same.reshape(-1)
    total = flat.numel()
    pad = (-total) % _SCAN_CHUNK
    flat = torch.cat([flat, flat.new_ones(pad)])
    gidx = torch.arange(total + pad, device=same.device)
    last = torch.where(flat, -1, gidx).view(-1, _SCAN_CHUNK).cummax(dim=1).values
    carry = last[:, -1].cummax(dim=0).values
    last[1:] = torch.maximum(last[1:], carry[:-1, None])
    return (gidx - last.view(-1))[:total].view(same.shape).to(torch.int32)


def _gamma_bits(u):
    """Elias-gamma code length: 2*floor(log2(u)) + 1 for u >= 1, and 1
    for the u == 0 wrap value. u < 2^16, so the float32 exponent is
    exact."""
    _, e = torch.frexp(u.to(torch.float32))
    return 2 * (e.to(torch.int32) - 1).clamp(min=0) + 1


def tokenize(values):
    """values: (..., n) int16 serialized streams -> per-position token
    pairs, flattened to (..., 2n): even slots are the (optional) literal
    at that position, odd slots the (optional) RLE token emitted right
    after it.

    Returns (vals, nbits): int32 token values (gamma argument, < 2^16)
    and int32 code lengths, 0 where no token is emitted."""
    n = values.shape[-1]
    v = values.to(torch.int32)

    # zigzag + 1, with the uint16 wrap for -32768 (kagari.c:169-175
    # through the uint16 argument truncation)
    z = ((v << 1) ^ (v >> 15)) & 0xFFFF
    u = (z + 1) & 0xFFFF

    same = torch.zeros_like(v, dtype=torch.bool)
    same[..., 1:] = values[..., 1:] == values[..., :-1]
    # distance to the last mismatch == the reference's run counter,
    # except that it keeps growing past the forced flush
    d = _run_lengths(same)
    # counter value after the forced-flush reset cycle
    rc = torch.where(d > 0, torch.remainder(d - 1, FLUSH_COUNTER) + 1, 0)

    lit_mask = (d == 0) | (rc <= RLE_TRIGGER)
    flush_mask = rc == FLUSH_COUNTER
    next_differs = torch.ones_like(same)
    next_differs[..., :-1] = ~same[..., 1:]
    end_mask = same & next_differs & (rc >= RLE_TRIGGER) & ~flush_mask
    tok_mask = flush_mask | end_mask
    # run token value: counter - trigger + 1 (kagari.c:199-204)
    tok_val = torch.where(flush_mask, FLUSH_COUNTER - RLE_TRIGGER + 1, rc - RLE_TRIGGER + 1)

    vals = torch.stack([torch.where(lit_mask, u, 0), torch.where(tok_mask, tok_val, 0)], dim=-1)
    mask = torch.stack([lit_mask, tok_mask], dim=-1)
    vals = vals.reshape(v.shape[:-1] + (2 * n,))
    nbits = _gamma_bits(vals) * mask.reshape(vals.shape)
    return vals, nbits


def pack_bits(vals, nbits, capacity_bytes: int):
    """Pack the gamma codes MSB-first into bytes.

    vals/nbits: (..., m) token values and code lengths (0 = no token,
    at most 31 bits). Returns (bytes uint8 (..., capacity_bytes),
    total_bits int64 (...)). Codes past the capacity are dropped, and
    bytes beyond ceil(total_bits/8) are zero."""
    batch = vals.shape[:-1]
    m = vals.shape[-1]
    cap_words = (capacity_bytes + 3) // 4
    nb = nbits.to(torch.int64)
    offs = _exclusive_cumsum(nb)
    total_bits = offs[..., -1] + nb[..., -1]

    word = offs >> 5
    shift = offs & 31
    # the code's MSB lands at bit `shift` of `word`: k1 bits go into
    # that word and the other k2 = nbits - k1 into the next one
    v = vals.to(torch.int64)
    k1 = torch.minimum(32 - shift, nb)
    k2 = nb - k1
    hi = torch.where(k1 > 0, (v >> k2) << (32 - shift - k1), 0)
    lo = torch.where(k2 > 0, (v & ((1 << k2) - 1)) << (32 - k2), 0)

    # per-word sums of disjoint bit ranges == their OR; the empty parts
    # and those past the capacity go to the row's spill slots
    rows = math.prod(batch)
    stride = cap_words + _SPILL_SLOTS
    row_base = (torch.arange(rows, device=v.device) * stride).reshape(batch + (1,))
    spill = cap_words + torch.arange(m, device=v.device) % _SPILL_SLOTS
    hi_at = torch.where((k1 > 0) & (word < cap_words), word, spill)
    lo_at = torch.where((k2 > 0) & (word + 1 < cap_words), word + 1, spill)
    words = torch.zeros(rows * stride, dtype=torch.int64, device=v.device)
    words.index_add_(0, (row_base + hi_at).reshape(-1), hi.reshape(-1))
    words.index_add_(0, (row_base + lo_at).reshape(-1), lo.reshape(-1))
    words = words.reshape(batch + (stride,))[..., :cap_words]

    # bit 0 of the stream is the MSB of word 0: bytes big-endian
    by = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)], dim=-1)
    by = by.reshape(batch + (4 * cap_words,))[..., :capacity_bytes]
    return by.to(torch.uint8), total_bits


def kagari_size_device(values):
    """Exact compressed payload size in bytes of (..., n) int16 streams,
    from the code lengths alone (no pack)."""
    _, nbits = tokenize(values)
    return (nbits.sum(dim=-1, dtype=torch.int64) + 7) >> 3


def encode_layout(n: int, budget_bytes: int) -> tuple:
    """Kernel K3's layout for streams of n values: (chunks per row,
    32-bit words per output row). A row's output is ceil(budget_bytes /
    4) words, so rows start on word boundaries and the caller's (rows,
    budget_bytes) bytes are a view of them."""
    return -(-n // K3_CHUNK), -(-budget_bytes // 4)


def scratch_words(rows: int, chunks: int) -> int:
    """64-bit words of K3's scratch for up to `rows` rows and `chunks`
    chunks in all (csrc/kagari_encode.cu ako_kagari_encode): two
    descriptors and two side-array entries a chunk, then the 32-bit
    ticket and one 32-bit counter a row."""
    return 4 * chunks + (rows + 2) // 2


def encode_scratch(device, stream: int, rows: int, chunks: int, words=scratch_words) -> list:
    """K3's scratch for a call on (device, stream), and the call's epoch
    taken: [tensor, rows held, chunks held, epoch]. Made zeroed once,
    made again larger when a call needs more, or when the epochs run
    out; otherwise reused as it is (the epoch makes the earlier calls'
    descriptors stale). `words` sizes the layout; a kernel with another
    layout (the rate search's K8p, ops/rate_device.py) passes its own and
    gets a scratch of its own."""
    key = (device.index, stream) + (() if words is scratch_words else (words,))
    with _SCRATCH_LOCK:
        s = _SCRATCH.get(key)
        if s is None or rows > s[1] or chunks > s[2] or s[3] + 1 >= K3_EPOCHS:
            rows = max(rows, s[1] if s else 0)
            chunks = max(chunks, s[2] if s else 0)
            s = [torch.zeros((words(rows, chunks),), dtype=torch.int64, device=device),
                 rows, chunks, 0]
            _SCRATCH[key] = s
        s[3] += 1
        return s


def take_scratch(device, stream: int, rows: int, chunks: int, words=scratch_words) -> tuple:
    """encode_scratch's (tensor, rows held, chunks held, epoch), read under
    its lock as this call took them (the executor launches from two
    threads at once)."""
    with _SCRATCH_LOCK:
        return tuple(encode_scratch(device, stream, rows, chunks, words))


def kagari_encode_device(values, capacity_bytes: int, budget_bytes: int | None = None):
    """Kagari encode of (..., n) int16 streams. Returns (bytes uint8
    (..., budget_bytes), total_bytes int64 (...)).

    total_bytes == ceil(total_bits / 8) is always exact; the bytes
    cover only `budget_bytes` (default capacity_bytes), so callers fall
    back to the host coder whenever total_bytes > budget_bytes.

    A CUDA tensor launches kernel K3 once; its bytes are a view of rows
    of ceil(budget_bytes / 4) words. A CPU tensor takes the plain version
    (tokenize + pack_bits)."""
    if budget_bytes is None:
        budget_bytes = capacity_bytes
    if values.device.type == "cpu":
        vals, nbits = tokenize(values)
        by, total_bits = pack_bits(vals, nbits, budget_bytes)
        return by, (total_bits + 7) >> 3
    if values.device.type != "cuda":
        raise ValueError(f"kagari_encode_device: no kernel for device {values.device}")
    n = values.shape[-1] if values.dim() else 0
    if values.dtype != torch.int16 or n == 0 or not values.is_contiguous():
        raise ValueError("kagari_encode_device: expected contiguous int16 (..., n) streams, n > 0, "
                         f"got {values.dtype} {tuple(values.shape)}")
    if budget_bytes < 1:
        raise ValueError(f"kagari_encode_device: budget {budget_bytes} bytes")
    batch = tuple(values.shape[:-1])
    rows = math.prod(batch)
    chunks, row_words = encode_layout(n, budget_bytes)
    out = torch.empty((rows, row_words * 4), dtype=torch.uint8, device=values.device)
    totals = torch.empty((rows,), dtype=torch.int64, device=values.device)
    if rows:
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream().cuda_stream
            scratch, rows_cap, chunks_cap, epoch = take_scratch(values.device, stream, rows,
                                                                rows * chunks)
            kernels.kagari_encode(values.data_ptr(), out.data_ptr(), totals.data_ptr(),
                                  scratch.data_ptr(), scratch.numel(), rows_cap, chunks_cap, epoch,
                                  rows, n, row_words, stream)
        kernels.count_launch(LAUNCHES, "kagari_encode")
    return out[:, :budget_bytes].reshape(batch + (budget_bytes,)), totals.reshape(batch)


# ---------------------------------------------------------------------
# Decode


def decode_span_words(bit_offsets, total_bits: int, slack: int = 3) -> int:
    """Host-side window width for the plain decoder: the most 32-bit
    words any block's decode touches, from the sync records' bit
    offsets, plus `slack` for the two-word prefetch."""
    boff = np.asarray(bit_offsets, np.int64)
    if boff.size == 0:
        return slack
    ends = np.concatenate([boff[1:], np.asarray([max(total_bits, 1)], np.int64)])
    spans = (ends - 1) // 32 - boff // 32 + 1
    return int(spans.max()) + slack


def decode_cta_spans(base, bit_off, pool_words: int) -> dict:
    """Kernel K4's CTAs and the pool words each stages, as the kernel
    computes them (csrc/kagari_decode.cu). A CTA takes K4_LANES
    consecutive lanes of one tile; it stages the words
    [base + bit_off[first] >> 5, base + (bit_off[last + 1] >> 5) + 2),
    where the tile's last lane ends two words past the tile's own (the
    next tile's base, or the pool's end before its DECODE_SLACK_WORDS),
    within the pool. A span of at most K4_SPAN_WORDS words takes the
    shared-memory route; a larger one reads the pool.

    base: (T,) and bit_off: (T, B) sync records (numpy or lists).
    Returns arrays, one entry per CTA in launch order: tile, first
    lane, lanes, start word, words and staged (bool)."""
    base = np.asarray(base, np.int64)
    boff = np.asarray(bit_off, np.int64) & _U32
    T, B = boff.shape
    per = -(-B // K4_LANES)
    tile = np.repeat(np.arange(T), per)
    first = np.tile(np.arange(per) * K4_LANES, T)
    lanes = np.minimum(K4_LANES, B - first)
    start = base[tile] + (boff[tile, first] >> 5)
    after = first + lanes
    inner = base[tile] + (boff[tile, np.minimum(after, B - 1)] >> 5) + 2
    nxt = np.where(tile + 1 < T, base[np.minimum(tile + 1, T - 1)], pool_words - DECODE_SLACK_WORDS)
    end = np.minimum(np.where(after < B, inner, nxt + 2), pool_words)
    words = end - start
    staged = (words > 0) & (words <= K4_SPAN_WORDS)
    return {"tile": tile, "first": first, "lanes": lanes, "start": start,
            "words": words, "staged": staged}


def _gamma_at(hi, lo, cur):
    """One gamma code from the 64-bit window (hi, lo) (int64 holding
    u32 values) at bit cursor `cur` (0..31): returns (value, length).
    Codes are at most 31 bits (longer ones only come from the
    zigzag(-32768) quirk, which callers keep on the host)."""
    top = ((hi << cur) | (lo >> (32 - cur))) & _U32
    z = torch.zeros_like(top)
    for k in range(1, 16):
        z += top < (1 << (32 - k))
    length = 2 * z + 1
    return top >> (32 - length), length


def _unzigzag(u):
    """Gamma value u -> int16-valued int64: (u-1) & 0xFFFF, zigzag
    decode, sign-extend (kagari.c:176-179)."""
    q = (u - 1) & 0xFFFF
    x = ((q >> 1) ^ ((q & 1) * 0xFFFF)) & 0xFFFF
    return x - ((x & 0x8000) << 1)


def _decode_plain(pool, base, bit_off, prev, consec, run, n_outputs: int, block: int,
                  span: int | None):
    """All (tile, block) lanes at once for `block` steps; each step
    emits one value (a literal, or one repeat of the pending run) and
    consumes 0, 1 (literal) or 2 (literal + run token) codes
    (ako_tpu/ops/kagari_device.py:626-647, kagari.c:301-366)."""
    T, B = bit_off.shape
    W = pool.shape[0]
    span = W if span is None else max(3, min(span, W))
    words = pool.to(torch.int64) & _U32
    boff = bit_off.to(torch.int64).reshape(-1) & _U32
    word0 = base.to(torch.int64).repeat_interleave(B) + (boff >> 5)
    cols = torch.arange(span, device=pool.device)
    # each lane's window of `span` words, gathered once
    win = words[(word0[:, None] + cols).clamp(0, W - 1)]
    ptr = torch.zeros_like(boff)
    cur = boff & 31
    prev = prev.to(torch.int64).reshape(-1)
    consec = consec.to(torch.int64).reshape(-1) & 0xFFFF
    runrem = run.to(torch.int64).reshape(-1) & 0xFFFF

    def window():
        hi = win.gather(1, ptr[:, None].clamp(max=span - 1))[:, 0]
        lo = win.gather(1, (ptr[:, None] + 1).clamp(max=span - 1))[:, 0]
        return hi, lo

    def advance(cur, ptr, n):
        cur = cur + n
        need = cur >= 32
        return torch.where(need, cur - 32, cur), ptr + need

    out = []
    for _ in range(block):
        in_run = runrem > 0
        u, ln = _gamma_at(*window(), cur)
        v = _unzigzag(u)
        cur, ptr = advance(cur, ptr, torch.where(in_run, 0, ln))

        first = consec == SYNC_FIRST
        eq = ~first & ~in_run & (v == prev)
        consec_lit = torch.where(eq, consec + 1, 0)
        trigger = ~in_run & (consec_lit == RLE_TRIGGER)
        u2, ln2 = _gamma_at(*window(), cur)
        cur, ptr = advance(cur, ptr, torch.where(trigger, ln2, 0))
        rle_len = (u2 - 1) & 0xFFFF

        out.append(torch.where(in_run, prev, v))
        prev = torch.where(in_run, prev, v)
        runrem = torch.where(in_run, runrem - 1, torch.where(trigger, rle_len, 0))
        consec = torch.where(in_run, consec, torch.where(trigger, 0, consec_lit))
    ys = torch.stack(out, dim=-1).reshape(T, B * block)[:, :n_outputs]
    return ys.to(torch.int16)


def kagari_decode_device(pool, base, bit_off, prev, consec, run, n_outputs: int,
                         block: int = DECODE_BLOCK, span: int | None = None):
    """Block-parallel Kagari decode of T tiles' streams.

    pool: (W,) int32, every tile's payload as big-endian 32-bit words
    (bit patterns), word-aligned at the tile's `base` (T,) int32, with
    DECODE_SLACK_WORDS zero words after the last. bit_off, prev,
    consec, run: (T, B) int32 sync records (runtime.kagari.kagari_sync),
    B = ceil(n_outputs / block). Returns (T, n_outputs) int16, bit-exact
    with the host decoder for every stream whose codes are <= 31 bits.

    A CUDA tensor launches kernel K4 (block must be DECODE_BLOCK; each
    CTA sizes its own window, decode_cta_spans, and `span` is ignored);
    a CPU tensor takes the plain version, whose per-lane window is
    `span` words wide (decode_span_words; None = the whole pool)."""
    T, B = bit_off.shape
    if pool.device.type == "cpu":
        return _decode_plain(pool, base, bit_off, prev, consec, run, n_outputs, block, span)
    if pool.device.type != "cuda":
        raise ValueError(f"kagari_decode_device: no kernel for device {pool.device}")
    if block != DECODE_BLOCK:
        raise ValueError(f"kagari_decode_device: the kernel decodes blocks of {DECODE_BLOCK}, "
                         f"not {block}")
    if B != -(-n_outputs // block):
        raise ValueError(f"kagari_decode_device: {B} sync records for {n_outputs} outputs")
    for name, t, shape in (("pool", pool, (pool.shape[0],)), ("base", base, (T,)),
                           ("bit_off", bit_off, (T, B)), ("prev", prev, (T, B)),
                           ("consec", consec, (T, B)), ("run", run, (T, B))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"kagari_decode_device: {name} must be contiguous int32 {shape}")
        if t.device != pool.device:
            raise ValueError(f"kagari_decode_device: {name} is not on {pool.device}")
    out = torch.empty((T, n_outputs), dtype=torch.int16, device=pool.device)
    with torch.cuda.device(pool.device):
        kernels.kagari_decode(
            pool.data_ptr(), pool.shape[0], base.data_ptr(), bit_off.data_ptr(),
            prev.data_ptr(), consec.data_ptr(), run.data_ptr(), out.data_ptr(),
            T, B, n_outputs, block, torch.cuda.current_stream().cuda_stream,
        )
    kernels.count_launch(LAUNCHES, "kagari_decode")
    return out

"""The arithmetic around ako_tpu_torch's Kagari kernels, which run only
on the card, held on the CPU to ako_tpu.ops.kagari_device under JAX and
to the host coder (akort.c) with exact equality.

- K3 (csrc/kagari_encode.cu): an emulation of its one launch, CTA by
  CTA under three seeded schedules (in ticket order, predecessors as
  late as they can be, random interleavings): tickets, the epoch-tagged
  descriptors of a reused scratch poisoned by earlier calls, both
  look-backs (a CTA reads only what is published), each thread's codes
  packed in a register with at most two shared ORs, the shifted store of
  each interior word once, the edge partials merged by the row's last
  CTA to finish (each shared word stored from the partial that holds its
  first bit, the others ORed in), and the zero tails; at small chunk sizes so that runs,
  forced flushes, -32768 and budget cuts fall across chunk edges.
- K4 (csrc/kagari_decode.cu): kagari_device.decode_cta_spans, the word
  span each CTA stages and the route it takes, on north-star-like and
  lossless-like records: every staged CTA's lanes decode exactly from its
  span alone (the pool poisoned outside it)."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ako_tpu.ops import kagari_device as ref_kd
from ako_tpu_torch.decode import pack_entropy_upload, split_entropy_upload
from ako_tpu_torch.ops import kagari_device as kd
from ako_tpu_torch.runtime import kagari
from tests.test_torch_kagari import STREAMS

_U32 = 0xFFFFFFFF


def _gamma_bits(u):
    u = np.asarray(u, np.int64)
    return np.where(u > 0, 2 * np.floor(np.log2(np.maximum(u, 1))).astype(np.int64) + 1, 1)


def _positions(v, c, chunk):
    """Row positions of chunk c, and their same / next-differs flags."""
    n = v.size
    p = np.arange(c * chunk, min((c + 1) * chunk, n))
    same = (p > 0) & (v[p] == v[np.maximum(p - 1, 0)])
    next_differs = (p == n - 1) | (v[np.minimum(p + 1, n - 1)] != v[p])
    return p, same, next_differs


def _chunk_codes(v, c, chunk, carry):
    """(values, bits) of chunk c's codes in stream order (literal, then
    token, per position; 0 bits = no code), from the carried last
    mismatch of the row's earlier chunks."""
    p, same, nd = _positions(v, c, chunk)
    last = np.maximum.accumulate(np.maximum(np.where(same, -1, p), carry))
    d = p - last
    rc = np.where(same, (d - 1) % kd.FLUSH_COUNTER + 1, 0)
    lit = ~same | (rc <= kd.RLE_TRIGGER)
    flush = rc == kd.FLUSH_COUNTER
    tok = flush | (same & nd & (rc >= kd.RLE_TRIGGER))
    x = v[p].astype(np.int64)
    u = ((((x << 1) ^ (x >> 15)) & 0xFFFF) + 1) & 0xFFFF
    t = np.where(flush, kd.FLUSH_COUNTER - kd.RLE_TRIGGER + 1, rc - kd.RLE_TRIGGER + 1)
    vals = np.stack([u, np.where(tok, t, 0)], -1).reshape(-1)
    mask = np.stack([lit, tok], -1).reshape(-1)
    return vals, np.where(mask, _gamma_bits(vals), 0)


ITEMS = 16  # kItems: positions a thread of K3 codes
WARP = 32
LOOK_BACK = WARP  # descriptors a look-back step reads: kLookBack a lane
BLOCKED = "blocked"  # what a CTA yields while a descriptor it needs is not published


class Scratch:
    """K3's scratch as the kernel sees it, reused across calls: the
    descriptors (one int each: (epoch << 1 | inclusive) << 32 | value),
    the side array of partial edge words, the ticket and the row
    counters, and the last epoch. A new scratch is poisoned as an earlier
    call on another layout would leave it: descriptors of older epochs
    (0 is a fresh zero), random side-array entries and output rows; only
    the counters are zero, as every call leaves them."""

    def __init__(self, rng, rows: int = 64, chunks: int = 4096):
        self.epoch = int(rng.integers(2, 1 << 20))
        old = lambda: (int(rng.integers(0, self.epoch)) << 33) | (int(rng.integers(0, 2)) << 32) \
            | int(rng.integers(0, 1 << 32))
        self.mm = [old() for _ in range(chunks)]
        self.bits = [old() for _ in range(chunks)]
        self.edges = [(int(rng.integers(0, 1 << 32)), int(rng.integers(0, 1 << 32)))
                      for _ in range(2 * chunks)]
        self.ticket = 0
        self.done = [0] * rows
        self.rng = rng


def _desc(epoch, inclusive, value):
    return ((epoch << 1 | int(inclusive)) << 32) | value


def _ready(d, epoch):
    return d >> 33 == epoch


def _look_back(descs, row0, idx, epoch, add):
    """Warp 0's look-back from chunk idx (> 0) of the row whose
    descriptors start at row0: LOOK_BACK predecessors at a time, nearest
    first, waiting until all of them are published; stops at the nearest
    inclusive one. Returns its value - 1 (carry 1) or the sum of the
    values up to it (carry 2)."""
    total, hi = 0, idx - 1
    while True:
        js = range(hi, max(hi - LOOK_BACK, -1), -1)
        while True:
            xs = [descs[row0 + j] for j in js]
            if all(_ready(x, epoch) for x in xs):
                break
            yield BLOCKED
        hit = next((lane for lane, x in enumerate(xs) if x >> 32 & 1), None)
        if add:
            total += sum(x & _U32 for x in xs[: len(xs) if hit is None else hit + 1])
        if hit is not None:
            return total if add else (xs[hit] & _U32) - 1
        assert hi - LOOK_BACK >= 0, "a row's first chunk is always inclusive"
        hi -= LOOK_BACK


def _pack_threads(vals, nb):
    """The chunk's codes (per position: literal, token) packed by its
    threads, ITEMS positions each, from chunk-relative bit 0: a
    position's two codes as one (at most 32 bits, as the kernel holds
    them); each thread assembles its words in a register and stores whole
    ones plainly, ORing only its first word (when it starts inside it) and
    its last partial one. Checks that a plainly stored word is no other
    thread's, and at most two ORs a thread. Returns the word buffer."""
    (lit_v, tok_v), (lit_n, tok_n) = vals.reshape(-1, 2).T.tolist(), nb.reshape(-1, 2).T.tolist()
    pos_vals = [(lv if ln else 0) << tn | tv for lv, tv, ln, tn in zip(lit_v, tok_v, lit_n, tok_n)]
    pos_bits = [ln + tn for ln, tn in zip(lit_n, tok_n)]
    assert max(pos_bits, default=0) <= 32 and max(pos_vals, default=0) < 1 << 17
    buf = np.zeros(len(pos_vals) + 2, np.int64)
    plain, ored = set(), set()
    o = 0
    for t in range(0, len(pos_vals), ITEMS):
        w, room, cur, shared_first, ors = o >> 5, 32 - (o & 31), 0, (o & 31) != 0, 0
        for code, n in zip(pos_vals[t : t + ITEMS], pos_bits[t : t + ITEMS]):
            if n == 0:
                continue
            o += n
            if n < room:
                cur |= code << (room - n)
                room -= n
                continue
            k2 = n - room
            cur |= code >> k2
            if shared_first:
                assert w not in plain
                buf[w] |= cur
                ored.add(w)
                ors += 1
            else:
                assert w not in plain and w not in ored
                buf[w] = cur
                plain.add(w)
            shared_first = False
            w += 1
            cur = (code << (32 - k2)) & _U32 if k2 else 0
            room = 32 - k2
        if room < 32:
            assert w not in plain
            buf[w] |= cur
            ored.add(w)
            ors += 1
        assert ors <= 2
    return buf


def _out_word(buf, k, skip):
    """__funnelshift_r(buf[k], buf[k - 1], skip)."""
    hi = int(buf[k - 1]) if k else 0
    return ((hi << 32 | int(buf[k])) >> skip) & _U32


class _Call:
    """One K3 launch on (R, n) rows: its CTAs as generators over the
    shared scratch, the output rows (poisoned; each word must be written
    exactly once) and the totals."""

    def __init__(self, S, values, budget, chunk, zero_words):
        self.S, self.v, self.chunk, self.zw = S, values, chunk, zero_words
        self.R, self.n = values.shape
        self.C = -(-self.n // chunk)
        self.row_words = -(-budget // 4)
        self.zslabs = -(-self.row_words // zero_words)
        self.grid = self.R * (self.C + self.zslabs)
        assert self.R <= len(S.done) and self.R * self.C <= len(S.mm)
        S.epoch += 1
        self.epoch = S.epoch
        self.out = S.rng.integers(0, 1 << 32, size=(self.R, self.row_words))
        self.writes = np.zeros((self.R, self.row_words), np.int64)
        self.totals = np.full(self.R, -1, np.int64)
        self.bit0s = np.zeros((self.R, self.C), np.int64)

    def _store(self, row, w, word):
        assert self.writes[row, w] == 0, f"row {row} word {w} written twice"
        self.writes[row, w] += 1
        self.out[row, w] = word

    def cta(self):
        S = self.S
        t = S.ticket
        S.ticket += 1
        if t == self.grid - 1:
            S.ticket = 0
        yield
        if t < self.R * self.C:
            yield from self._chunk(t)
        else:
            yield from self._zero(t - self.R * self.C)

    def _chunk(self, g):
        S, E, C = self.S, self.epoch, self.C
        row, idx = divmod(g, C)
        v = self.v[row]
        p, same, _ = _positions(v, idx, self.chunk)
        chunk_mm = int(p[~same].max(initial=-1))
        S.mm[g] = _desc(E, chunk_mm >= 0, chunk_mm + 1)
        yield
        carry = -1
        if same[0]:
            carry = yield from _look_back(S.mm, row * C, idx, E, add=False)
            if chunk_mm < 0:
                S.mm[g] = _desc(E, True, carry + 1)
            yield
        vals, nb = _chunk_codes(v, idx, self.chunk, carry)
        bits = int(nb.sum())
        S.bits[g] = _desc(E, idx == 0, bits)
        yield
        buf = _pack_threads(vals, nb)
        before = 0
        if idx:
            before = yield from _look_back(S.bits, row * C, idx, E, add=True)
            S.bits[g] = _desc(E, True, before + bits)
        if idx == C - 1:
            self.totals[row] = (before + bits + 7) >> 3
        self.bit0s[row, idx] = before
        yield
        skip, w0, end = before & 31, before >> 5, before + bits
        nw = ((end - 1) >> 5) - w0 + 1 if bits else 0
        for k in range(nw):
            edge = (k == 0 and skip) or (k == nw - 1 and end & 31)
            if not edge and w0 + k < self.row_words:
                self._store(row, w0 + k, _out_word(buf, k, skip))
        none = (_U32, 0)
        first = (w0, _out_word(buf, 0, skip)) if nw and skip else none
        tail = (w0 + nw - 1, _out_word(buf, nw - 1, skip)) \
            if nw and end & 31 and (nw > 1 or not skip) else none
        S.edges[2 * g], S.edges[2 * g + 1] = first, tail
        yield
        S.done[row] += 1
        if S.done[row] == C:
            S.done[row] = 0
            self._merge(row)

    def _merge(self, row):
        """The last partials (odd entries) stored, then the first
        partials (even entries) ORed into them: each of those words must
        have been stored by a last partial of this merge."""
        e = self.S.edges[2 * row * self.C : 2 * (row + 1) * self.C]
        heads = set()
        for w, bits in e[1::2]:
            if w < self.row_words:
                self._store(row, w, bits)
                heads.add(w)
        for w, bits in e[0::2]:
            if w < self.row_words:
                assert w in heads, f"row {row}: a first partial of word {w} has no last partial"
                self.out[row, w] |= bits

    def _zero(self, z):
        row, slab = divmod(z, self.zslabs)
        last = row * self.C + self.C - 1
        while not (_ready(self.S.bits[last], self.epoch) and self.S.bits[last] >> 32 & 1):
            yield BLOCKED
        end = self.S.bits[last] & _U32
        for w in range(max(slab * self.zw, (end + 31) >> 5),
                       min((slab + 1) * self.zw, self.row_words)):
            self._store(row, w, 0)


SCHEDULES = ("in_order", "late", "random")


def _run(call, schedule, seed):
    """Start the call's CTAs, each taking its ticket as it starts, and
    step them to the end: `in_order` one at a time (no CTA may wait);
    `late` up to 24 resident, always stepping the newest that can move,
    so predecessors publish as late as they can; `random` a random
    resident count and random steps. Fails on a deadlock."""
    rng = np.random.default_rng(seed)
    resident = {"in_order": 1, "late": 24, "random": int(rng.integers(2, 40))}[schedule]
    running, started = [], 0
    while running or started < call.grid:
        if started < call.grid and len(running) < resident and (
                schedule != "random" or not running or rng.random() < 0.3):
            gen = call.cta()
            next(gen)  # takes its ticket
            running.append(gen)
            started += 1
            continue
        order = list(range(len(running)))[::-1]
        if schedule == "random":
            rng.shuffle(order)
        for i in order:
            try:
                if next(running[i]) is not BLOCKED:
                    break
            except StopIteration:
                running.pop(i)
                break
            assert schedule != "in_order", "a CTA waited in ticket order"
        else:
            raise AssertionError("deadlock: every resident CTA waits")


def emulate_k3(values, budget: int, chunk: int, schedule: str = "in_order", seed: int = 0,
               scratch: Scratch | None = None, zero_words: int = 16):
    """K3's one launch on (R, n) int16 rows with `chunk` positions a CTA
    and `zero_words` words a zeroing CTA, under a schedule, on `scratch`
    (default: a new poisoned one). Returns (bytes (R, budget) uint8,
    totals (R,), per-chunk first bit offsets (R, chunks))."""
    values = np.atleast_2d(np.asarray(values, np.int16)).astype(np.int64)
    S = scratch or Scratch(np.random.default_rng(seed + 1), len(values),
                           len(values) * -(-values.shape[1] // chunk))
    call = _Call(S, values, budget, chunk, zero_words)
    _run(call, schedule, seed)
    assert (call.writes == 1).all(), "a word of the rows was not written"
    assert S.ticket == 0 and not any(S.done)
    by = call.out.astype(">u4").view(np.uint8).reshape(call.R, -1)[:, :budget]
    return by, call.totals, call.bit0s


@functools.lru_cache(maxsize=None)
def _jax_encode(name: str, cap: int, budget: int):
    v = _stream(name)
    by, total = jax.jit(ref_kd.kagari_encode_device, static_argnums=(1, 2))(jnp.asarray(v), cap,
                                                                            budget)
    return np.asarray(by), int(total)


def _runs_across_edges():
    return [1] * 60 + [2] * 10 + [3] * 990 + [4] * 5 + [5] * 200 + list(range(50)) + [0] * 1000 \
        + [9] * 64 + [8] * 64


def _int16_min_at_chunk_starts():
    v = np.random.default_rng(0x8000).integers(-40, 40, size=2100)
    v[[0, 64, 1000, 2000]] = -32768
    v[126:131] = -32768  # a run of the wrap value across position 128
    return v


def _int16_min_every_chunk_start():
    v = np.random.default_rng(0x8001).integers(-3, 3, size=4100)
    v[::64] = -32768
    v[::1000] = -32768
    return v


def _run_with_flush_over_chunks():
    """A run of 67534 values, noise on each side: more than 16 chunks of
    either size (1055 of 64) with no mismatch, a forced flush inside."""
    rng = np.random.default_rng(0xF1)
    return np.concatenate([rng.integers(-50, 50, size=300), np.full(65534 + 2000, 11),
                           rng.integers(-50, 50, size=300)])


def _row_of_1281_chunks():
    """The whole-image tile's chunk count at chunk size 64 (its 5,242,932
    values at 4096 a chunk), cut from 5.2 M values to 81,984: sparse
    small values and runs, as a lossy stream."""
    rng = np.random.default_rng(0x501)
    v = np.where(rng.random(1281 * 64) < 0.75, 0, rng.integers(-20, 20, size=1281 * 64))
    v[40000:46000] = 3
    return v


EDGES = {
    "runs_across_edges": _runs_across_edges,
    "flush_later_chunk": lambda: [7] * (1 + 2 * 65534 + 10),
    "int16_min_at_chunk_starts": _int16_min_at_chunk_starts,
    "int16_min_every_chunk_start": _int16_min_every_chunk_start,
    "run_with_flush_over_chunks": _run_with_flush_over_chunks,
    "all_one_value": lambda: [-5] * 20000,
    "row_of_1281_chunks": _row_of_1281_chunks,
}
ALL = {**STREAMS, **EDGES}


@functools.lru_cache(maxsize=None)
def _stream(name):
    return np.asarray(ALL[name](), np.int16)


def _capacity(v):
    return max(v.nbytes * 4, 64)


@pytest.mark.parametrize("chunk", [64, 1000])
@pytest.mark.parametrize("name", list(ALL))
def test_k3_chunks_match_reference(name, chunk):
    """Full capacity, under each schedule: the emulation's bytes and
    total equal ako_tpu's, the host coder's and the plain version's."""
    v = _stream(name)
    cap = _capacity(v)
    ref_by, ref_total = _jax_encode(name, cap, cap)
    assert ref_by[:ref_total].tobytes() == kagari.kagari_encode(v, cap)
    plain_by, plain_total = kd.kagari_encode_device(torch.from_numpy(v), cap)
    assert int(plain_total) == ref_total
    np.testing.assert_array_equal(plain_by.numpy(), ref_by)
    for seed, schedule in enumerate(SCHEDULES):
        by, totals, _ = emulate_k3(v, cap, chunk, schedule, seed)
        assert int(totals[0]) == ref_total, schedule
        np.testing.assert_array_equal(by[0], ref_by, err_msg=schedule)


def test_k3_empty_chunks():
    """Inside a run the chunks code no bits: all of a row that is one
    value but its first and last chunk, and a run's chunks but the one
    with its flush. Their look-backs cross more than a warp-width of
    chunks with no mismatch (carry 1) and of zero aggregates (carry 2)."""
    for name in ("all_one_value", "run_with_flush_over_chunks"):
        v = _stream(name)
        _, nbits = kd.tokenize(torch.from_numpy(v))
        bits = np.add.reduceat(nbits.numpy().reshape(-1, 2).sum(1), np.arange(0, v.size, 64))
        assert (bits == 0).sum() > 2 * LOOK_BACK
        _, _, bit0s = emulate_k3(v, _capacity(v), 64, "late", 7)
        np.testing.assert_array_equal(bit0s[0], np.cumsum(bits) - bits)


@pytest.mark.parametrize("chunk", [64, 1000])
@pytest.mark.parametrize("name", ["random_runs", "int16_min_at_chunk_starts"])
def test_k3_budget_cuts(name, chunk):
    """Budgets that cut inside a chunk's words and on a chunk edge (the
    word, and the byte, where chunk 2 begins), before, inside and at the
    end of the first word two chunks share, and one past the end."""
    v = _stream(name)
    cap = _capacity(v)
    _, _, bit0s = emulate_k3(v, cap, chunk)
    b = int(bit0s[0, 2])
    shared = int(next(x for x in bit0s[0, 1:] if x & 31)) >> 5
    full = kagari.kagari_encode(v, cap)
    for i, budget in enumerate((b // 8 + 3, (b >> 5) * 4, b // 8, 4 * shared, 4 * shared + 1,
                                4 * shared + 4, len(full) + 5)):
        by, totals, _ = emulate_k3(v, budget, chunk, SCHEDULES[i % 3], i)
        ref_by, ref_total = _jax_encode(name, cap, budget)
        assert int(totals[0]) == ref_total == len(full)
        np.testing.assert_array_equal(by[0], ref_by)
        want = np.zeros(budget, np.uint8)
        m = min(budget, len(full))
        want[:m] = np.frombuffer(full[:m], np.uint8)
        np.testing.assert_array_equal(by[0], want)


def _rows():
    rng = np.random.default_rng(0xBA7C)
    n = 3000
    return np.stack([
        rng.integers(-3000, 3000, size=n),
        np.zeros(n, np.int64),
        np.repeat(rng.integers(-9, 9, size=n // 30), 30),
        np.where(rng.random(n) < 0.7, 0, rng.integers(-5, 5, size=n)),
    ]).astype(np.int16)


def test_k3_batch_of_rows():
    """Rows of different content in one call, under each schedule: each
    row as ako_tpu codes it alone (jax.vmap, its fused encoder's
    batching), and the host coder."""
    rows = _rows()
    cap, budget = 4 * rows.shape[1], 2000
    ref_by, ref_total = jax.jit(jax.vmap(lambda x: ref_kd.kagari_encode_device(x, cap, budget)))(
        jnp.asarray(rows))
    plain_by, plain_total = kd.kagari_encode_device(torch.from_numpy(rows), cap, budget)
    np.testing.assert_array_equal(plain_total.numpy(), np.asarray(ref_total))
    np.testing.assert_array_equal(plain_by.numpy(), np.asarray(ref_by))
    for i, row in enumerate(rows):
        full = kagari.kagari_encode(row, cap)
        m = min(budget, len(full))
        assert plain_by.numpy()[i, :m].tobytes() == full[:m] and not plain_by.numpy()[i, m:].any()
    for seed, schedule in enumerate(SCHEDULES):
        by, totals, _ = emulate_k3(rows, budget, 1000, schedule, seed)
        np.testing.assert_array_equal(totals, np.asarray(ref_total))
        np.testing.assert_array_equal(by, np.asarray(ref_by))


def test_k3_scratch_reuse():
    """Calls of other shapes back to back on one scratch, as the wrapper
    reuses it: each call's epoch leaves the others' descriptors stale."""
    S = Scratch(np.random.default_rng(5), 8, 4096)
    rows = _rows()
    for i, (v, budget, chunk) in enumerate([(rows, 2000, 1000), (_stream("random_runs"), 900, 64),
                                            (rows[1:3], 12000, 64), (rows, 2000, 1000)]):
        v = np.atleast_2d(v)
        by, totals, _ = emulate_k3(v, budget, chunk, SCHEDULES[i % 3], i, scratch=S)
        plain_by, plain_total = kd.kagari_encode_device(torch.from_numpy(v), 4 * v.shape[1],
                                                        budget)
        np.testing.assert_array_equal(totals, plain_total.numpy())
        np.testing.assert_array_equal(by, plain_by.numpy())


def test_k3_layout_and_wrapper():
    """encode_layout's chunks and padded row words; the scratch's size
    and reuse; the wrapper takes the plain version on the CPU (no launch
    counted) and raises on a device with no kernel."""
    assert kd.encode_layout(65560, 65558) == (17, 16390)
    assert kd.encode_layout(5242932, 5242928) == (1281, 1310732)
    assert kd.encode_layout(kd.K3_CHUNK, 4) == (1, 1)
    assert kd.scratch_words(80, 1360) == 4 * 1360 + 41
    dev, stream = torch.device("cpu"), 7
    first = kd.encode_scratch(dev, stream, 4, 10)
    assert first[1:] == [4, 10, 1] and not first[0].any()
    assert kd.encode_scratch(dev, stream, 2, 3) is first and first[3] == 2
    grown = kd.encode_scratch(dev, stream, 2, 30)
    assert grown[1:] == [4, 30, 1] and grown[0].numel() == kd.scratch_words(4, 30)
    grown[3] = kd.K3_EPOCHS - 1
    assert kd.encode_scratch(dev, stream, 1, 1)[1:] == [4, 30, 1]
    kd._SCRATCH.pop((dev.index, stream))
    before = dict(kd.LAUNCHES)
    v = torch.tensor([5, 5, 5, 5, 1], dtype=torch.int16)
    by, total = kd.kagari_encode_device(v, 64)
    assert by.numpy()[: int(total)].tobytes() == kagari.kagari_encode(v.numpy(), 64)
    assert kd.LAUNCHES == before
    with pytest.raises(ValueError, match="no kernel"):
        kd.kagari_encode_device(v.to("meta"), 64)


# ----------------------------------------------------------------- K4


def _north_star_like_tiles():
    """Two 128-px RGBA tiles of the north-star corpus image, lifted and
    quantized at q=16 as the encoder does (plain version on the CPU)."""
    from ako_tpu_torch import Settings
    from ako_tpu_torch.encode import checked_settings, forward_streams
    from ako_tpu_torch.utils.corpus import corpus

    img = corpus(42, 1, 128, 256, 4)[0]
    s = checked_settings(Settings(quantization=16, tiles_dimension=128))
    tiles = torch.from_numpy(np.stack([img[:, :128], img[:, 128:]]).copy())
    return list(forward_streams(tiles, 128, 128, 4, s).numpy())


def _lossless_like():
    """High-entropy values (no -32768, whose code is the host's quirk
    route), as lossless streams of noisy tiles give."""
    rng = np.random.default_rng(0x1055)
    return [rng.integers(-32767, 32768, size=20000).astype(np.int16),
            rng.integers(-20, 20, size=20000).astype(np.int16)]


def _upload(streams):
    items = []
    for v in streams:
        cap = v.size * 2 + 64
        payload = kagari.kagari_encode(v, cap * 4)
        sync = kagari.kagari_sync(v.size, payload, cap, kd.DECODE_BLOCK)
        assert sync is not None and sync[5] <= 31
        items.append((None, payload, sync))
    buf, T, B = pack_entropy_upload(items)
    return split_entropy_upload(torch.from_numpy(buf), T, B)


def _check_staged_spans(streams):
    """Every staged CTA's lanes decode exactly with the pool poisoned
    outside its span. Returns decode_cta_spans' result."""
    parts = _upload(streams)
    pool, base, bit_off, prev, consec, run = parts
    n = streams[0].size
    spans = kd.decode_cta_spans(base.numpy(), bit_off.numpy(), pool.shape[0])
    T, B = bit_off.shape
    assert len(spans["tile"]) == T * -(-B // kd.K4_LANES)
    assert spans["lanes"].sum() == T * B
    for t, first, lanes, start, words, staged in zip(*(spans[k] for k in (
            "tile", "first", "lanes", "start", "words", "staged"))):
        if not staged:
            continue
        poisoned = torch.full_like(pool, 0x5A5A5A5A)
        poisoned[start : start + words] = pool[start : start + words]
        sel = slice(first, first + lanes)
        recs = [a[t : t + 1, sel].contiguous() for a in (bit_off, prev, consec, run)]
        count = min(lanes * kd.DECODE_BLOCK, n - first * kd.DECODE_BLOCK)
        got = kd._decode_plain(poisoned, base[t : t + 1], *recs, count, kd.DECODE_BLOCK, None)
        want = streams[t][first * kd.DECODE_BLOCK : first * kd.DECODE_BLOCK + count]
        np.testing.assert_array_equal(got.numpy()[0], want)
    return spans


def test_k4_spans_north_star_like():
    """128-px q=16 tiles: every CTA fits the shared-memory route, and its
    span alone decodes its lanes."""
    spans = _check_staged_spans(_north_star_like_tiles())
    assert spans["staged"].all()
    assert (spans["words"] >= 2).all()


def test_k4_spans_lossless_like():
    """High-entropy lanes overflow the staged span and read the pool
    (the tile's last, short CTA fits again); narrow ones in the same
    call stay staged."""
    spans = _check_staged_spans(_lossless_like())
    wide = spans["tile"] == 0
    assert not spans["staged"][wide][:-1].any()
    assert (spans["words"][wide][:-1] > kd.K4_SPAN_WORDS).all()
    assert spans["staged"][~wide].all()


def test_kernel_constants_match_sources():
    """The constants the wrappers and span helpers share with the CUDA
    sources."""
    by_name = {os.path.basename(p): open(p).read() for p in kd.kernels.SOURCES}
    k3 = by_name["kagari_encode.cu"]
    threads = int(re.search(r"kThreads = (\d+);", k3).group(1))
    items = int(re.search(r"kItems = (\d+);", k3).group(1))
    assert threads * items == kd.K3_CHUNK and items == ITEMS
    assert f"kLookBack = {LOOK_BACK // WARP};" in k3
    assert "epoch >= (1u << 31)" in k3 and kd.K3_EPOCHS == 1 << 31
    k4 = by_name["kagari_decode.cu"]
    for const, value in (("kLanes", kd.K4_LANES), ("kSpanWords", kd.K4_SPAN_WORDS),
                         ("kBlock", kd.DECODE_BLOCK), ("kSlackWords", kd.DECODE_SLACK_WORDS)):
        assert f"{const} = {value};" in k4

"""Kernel K6d (ako_tpu_torch/csrc/manba_decode.cu, the Manbavaran block
decoder) as it runs on the card, emulated CTA by CTA in numpy on the CPU:
the launcher's cut of each tile's warps into CTAs, the slot table as each
CTA builds it (the shuffle scan of the frequencies, every symbol's slots
filled by all threads, each slot written once), each lane's two windows
with 32-bit word cursors clamped to their last words and every pool word
outside a lane's own span poisoned, the select-based advance and its
loads, the refill candidates picked by the renorm compares, and the
outputs' stores, sixteen steps at a time through each warp's buffer in
16-byte stores (or two-byte ones), each output written exactly once.
The emulation is held against the plain version (ops/manba_device.py
manba_decode_plain), ako_tpu.ops.manba_device.manba_decode_device under
JAX on the CPU and the coded streams; the tests pin the source lines they
emulate. Every comparison is exact equality."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ako_tpu.ops import manba_device as ref_md
from ako_tpu.runtime import kagari as ref_kagari
from ako_tpu_torch.decode import pack_manba_upload, split_manba_upload
from ako_tpu_torch.ops import manba_device as md
from ako_tpu_torch.ops.kagari_device import DECODE_SLACK_WORDS

SRC = os.path.join(os.path.dirname(md.__file__), "..", "csrc", "manba_decode.cu")
SMS = 132  # an H100's SMs, as the launcher reads them
M32 = np.uint64(0xFFFFFFFF)
POISON = np.uint64(0xA5C3_0F69)

# the kernel's constants and cost estimates (pinned by test_source_pins)
BLOCK, GROUP, MAX_WARPS = 128, 16, 16
SYM_SHIFT, BIAS_SHIFT = 13, 20
TABLE_COST, WARP_COST = 1000, 6000


@functools.lru_cache(maxsize=None)
def _source():
    return open(SRC).read()


def test_source_pins():
    """The lines of csrc/manba_decode.cu that the emulation follows."""
    src = _source()
    for line in (
        "constexpr int kBlock = 128;",
        "constexpr int kGroup = 16;",
        "constexpr int kMaxWarps = 16;",
        "constexpr int kSymShift = 13;",
        "constexpr int kBiasShift = 20;",
        "constexpr long long kTableCost = 1000;",
        "constexpr long long kWarpCost = 6000;",
        # the cut of a tile's warps
        "for (int parts = (warps + kMaxWarps - 1) / kMaxWarps; parts <= warps; ++parts) {",
        "const long long per_sm = ((long long)tiles * parts + sms - 1) / sms;",
        "const long long cost = per_sm * (kTableCost + kWarpCost * ((warps + parts - 1) / parts));",
        "if (cost < best_cost) {",
        "const int wa = (int)((long long)part * warps / parts);",
        "const int wb = (int)((long long)(part + 1) * warps / parts);",
        "const int warps = ((blocks + 31) / 32 + parts - 1) / parts;",
        # the table
        "const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, cum, d);",
        "const uint32_t hi = s == kSyms - 1 ? (uint32_t)kSlots : min(lo + fs, (uint32_t)kSlots);",
        "const uint32_t a = fs | (uint32_t)s << kSymShift | (0u - lo) << kBiasShift;",
        "for (uint32_t j = min(lo, (uint32_t)kSlots) + tid; j < hi; j += blockDim.x)",
        "table[j] = a + (j << kBiasShift);",
        # the windows
        "const uint32_t rlast = rend > 0 ? b + (rend - 1) / 4 : b;",
        "r.start(pool, b + rb / 4, (rb & 3) * 8, min(rlast, pool_words - 1));",
        "const unsigned long long ebits = (unsigned long long)eoff * 8 + eb;",
        "e.start(pool, b + (uint32_t)(ebits >> 5), (uint32_t)(ebits & 31), pool_words - 1);",
        "int rbits = 8 * (int)max(min(rleft, 1LL << 24), -1LL);",
        "n2 = __ldg(pool + min(word + 3, lim));",
        "if (!kSecond) return __funnelshift_l(w1, w0, pos);",
        "return __funnelshift_l(m ? n1 : w1, m ? w1 : w0, pos);",
        "n1 = m ? n2 : n1;",
        "if (m) n2 = __ldg(pool + min(j + first3, last));",
        "v[j + 1] = step<true>(x, rbits, r, e, table);",
        # the step
        "x = (t & ((1u << kSymShift) - 1)) * (x >> kProbBits) + (t >> kBiasShift);",
        "const bool n1 = x < (kStateLo >> 8) && rbits >= 16;",
        "const uint32_t x1 = __funnelshift_l(top, x, 8), x2 = __funnelshift_l(top, x, 16);",
        "const uint32_t code = __funnelshift_l(e.top<kSecond>(), 1u, sh);",
        "e.pos += sh & 31;",
        "return ((q >> 1) & 0x7FFFu) ^ (uint32_t)((int32_t)(q << 31) >> 31);",
        # the stores
        "constexpr int kRowBytes = kGroup * 2 + 16;",
        "const int len = min(32 * kBlock, n - lane0 * kBlock);",
        "int16_t* dst = out + (size_t)tile * n + (size_t)lane0 * kBlock;",
        "const bool vec = (reinterpret_cast<uintptr_t>(dst) & 15) == 0;",
        "const int src = p * 16 + (lane_id >> 1), h = lane_id & 1;",
        "const int o = src * kBlock + g * kGroup + h * 8;  // its first output",
        "if (o + 8 <= len) {",
        "if (at + j < len) dst[at + j] = (int16_t)(uint16_t)v[j];",
        "pool_words > INT_MAX - 4",
    ):
        assert line in src, line
    assert md.K6D_MAX_POOL_WORDS == 2**31 - 5


# ---------------------------------------------------------------- geometry


def cta_parts(tiles, blocks, sms=SMS):
    """csrc/manba_decode.cu cta_parts: CTAs a tile."""
    warps = -(-blocks // 32)
    best, best_cost = warps, None
    for parts in range(-(-warps // MAX_WARPS), warps + 1):
        per_sm = -(-tiles * parts // sms)
        cost = per_sm * (TABLE_COST + WARP_COST * -(-warps // parts))
        if best_cost is None or cost < best_cost:
            best, best_cost = parts, cost
    return best


def ctas(tiles, blocks, sms=SMS):
    """The launch: (threads a CTA, [(tile, its active lanes)] a CTA)."""
    parts = cta_parts(tiles, blocks, sms)
    warps = -(-blocks // 32)
    threads = -(-warps // parts) * 32
    out = []
    for cta in range(tiles * parts):
        tile, part = divmod(cta, parts)
        wa, wb = part * warps // parts, (part + 1) * warps // parts
        lanes = wa * 32 + np.arange(threads)
        out.append((tile, lanes[(lanes < wb * 32) & (lanes < blocks)]))
    return threads, out


@pytest.mark.parametrize("tiles,blocks,parts,threads", [
    (80, 513, 3, 192),        # the north star at 128-px tiles: one wave, 2 CTAs on most SMs
    (1, 40961, 129, 320),     # the default whole tile: one CTA of 9-10 warps an SM
    (80, 1, 1, 32),
    (1, 33, 2, 32),           # a second CTA of one lane
    (3, 8, 1, 32),
    (1000, 64, 1, 64),
])
def test_cta_geometry(tiles, blocks, parts, threads):
    """The cut the launcher picks, and every lane of every tile in
    exactly one CTA, no CTA over 16 warps."""
    assert cta_parts(tiles, blocks) == parts
    got_threads, launch = ctas(tiles, blocks)
    assert got_threads == threads and threads <= MAX_WARPS * 32
    seen = np.zeros((tiles, blocks), np.int64)
    for tile, lanes in launch:
        np.add.at(seen[tile], lanes, 1)
    assert (seen == 1).all()
    if (tiles, blocks) == (80, 513):
        # 17 warps a tile as 5 + 6 + 6 (the last holding the tile's 513th
        # lane), 240 CTAs: at most two an SM
        assert sorted({len(lanes) for _, lanes in launch}) == [160, 161, 192]
        assert -(-len(launch) // SMS) == 2


# ---------------------------------------------------------------- table


def build_table(freq, threads):
    """One CTA's slot table as manba_decode builds it: (table, the stores
    each slot took)."""
    f = np.zeros(32, np.uint64)
    f[:17] = np.asarray(freq, np.uint64)
    cum = f.copy()
    d = 1
    while d < 32:  # __shfl_up_sync, every lane at once
        cum = np.where(np.arange(32) >= d, cum + np.roll(cum, d), cum) & M32
        d *= 2
    cum = (cum - f) & M32
    table = np.zeros(4096, np.uint64)
    stores = np.zeros(4096, np.int64)
    for s in range(17):
        lo, fs = int(cum[s]), int(f[s])
        hi = 4096 if s == 16 else min(lo + fs, 4096)
        a = (fs | s << SYM_SHIFT | ((-lo) & 0xFFFFFFFF) << BIAS_SHIFT) & 0xFFFFFFFF
        for tid in range(threads):
            j = np.arange(min(lo, 4096) + tid, hi, threads, dtype=np.int64)
            table[j] = (np.uint64(a) + (j.astype(np.uint64) << np.uint64(BIAS_SHIFT))) & M32
            np.add.at(stores, j, 1)
    return table, stores


def _models():
    rng = np.random.default_rng(0x6D)
    ones = np.zeros(17, np.int64)
    ones[3] = 4096                     # one symbol, f = 4096
    ends = np.zeros(17, np.int64)
    ends[1:16] = 4096 // 15
    ends[5] += 4096 - ends.sum()       # zero frequencies at both ends
    rand = rng.multinomial(4096 - 17, np.ones(17) / 17) + 1
    sparse = np.zeros(17, np.int64)
    sparse[[0, 7, 16]] = [1, 4094, 1]
    return {"f4096": ones, "zero_ends": ends, "random": rand, "sparse": sparse}


@pytest.mark.parametrize("name", ["f4096", "zero_ends", "random", "sparse"])
@pytest.mark.parametrize("threads", [32, 192, 320])
def test_table(name, threads):
    """Every slot is stored once, and its entry gives the symbol, f and
    slot - cum that the plain version finds by its 16 compares."""
    freq = _models()[name]
    assert freq.sum() == 4096
    table, stores = build_table(freq, threads)
    assert (stores == 1).all()
    slot = np.arange(4096)
    cum = np.cumsum(freq) - freq
    sym = (np.cumsum(freq)[:16][None, :] <= slot[:, None]).sum(axis=1)
    t = table.astype(np.int64)
    np.testing.assert_array_equal(t & 0x1FFF, freq[sym])
    np.testing.assert_array_equal((t >> SYM_SHIFT) & 31, sym)
    np.testing.assert_array_equal(t >> BIAS_SHIFT, slot - cum[sym])


# ---------------------------------------------------------------- the lanes


def _funnel_l(lo, hi, sh):
    """__funnelshift_l(lo, hi, sh): the high word of (hi:lo) << (sh & 31)."""
    sh = np.asarray(sh, np.uint64) & np.uint64(31)
    return ((hi << sh) | (lo >> (np.uint64(32) - sh))) & M32


class Window:
    """csrc/manba_decode.cu Window for a CTA's lanes at once; `read`
    gives the pool word at an index for each lane (poisoned outside its
    span) and checks that every load lies in the pool."""

    def __init__(self, read, word, bit, last):
        self.read, self.pos, self.i, self.first3, self.last = read, bit, 0 * bit, word + 3, last
        self.w0, self.w1, self.n1, self.n2 = (read(np.minimum(word + k, last)) for k in range(4))
        self.loaded = {}  # lanes' words loaded at a pair's end, by the step they were loaded at

    def top(self, second):
        if not second:
            return _funnel_l(self.w1, self.w0, self.pos)
        m = (self.pos >> np.uint64(5)) != self.i
        return _funnel_l(np.where(m, self.n1, self.w1), np.where(m, self.w1, self.w0), self.pos)

    def move(self):
        j = self.pos >> np.uint64(5)
        m = j != self.i
        assert (j - self.i <= 1).all()  # at most one word a pair
        self.w0 = np.where(m, self.w1, self.w0)
        self.w1 = np.where(m, self.n1, self.w1)
        self.n1 = np.where(m, self.n2, self.n1)
        # the predicated load: only the lanes whose window moves load
        self.n2 = np.where(m, self.read(np.minimum(j + self.first3, self.last), m), self.n2)
        self.i = j


def _step(x, rbits, r, e, table, second):
    t = table[(x & np.uint64(4095)).astype(np.int64)]
    x = ((t & np.uint64(0x1FFF)) * (x >> np.uint64(12)) + (t >> np.uint64(BIAS_SHIFT))) & M32
    top = r.top(second)
    n0 = (x < np.uint64(1 << 23)) & (rbits >= 8)
    n1 = (x < np.uint64(1 << 15)) & (rbits >= 16)
    x1, x2 = _funnel_l(top, x, 8), _funnel_l(top, x, 16)
    x = np.where(n1, x2, np.where(n0, x1, x))
    k = np.where(n1, 16, np.where(n0, 8, 0)).astype(np.uint64)
    rbits = rbits - k.astype(np.int64)
    r.pos = r.pos + k
    sh = t >> np.uint64(SYM_SHIFT)
    code = _funnel_l(e.top(second), np.ones_like(x), sh)  # the funnel takes sh's low 5 bits
    e.pos = e.pos + (sh & np.uint64(31))
    q = (code - np.uint64(1)) & M32
    sign = np.where(q & np.uint64(1), M32, np.uint64(0))  # (int32_t)(q << 31) >> 31
    v = ((q >> np.uint64(1)) & np.uint64(0x7FFF)) ^ sign
    return x, rbits, (v & np.uint64(0xFFFF)).astype(np.int64)


def emulate(pool, base, rans_end, extras_off, x0, rbyte, ebit, freq, n, spans=None, sms=SMS):
    """K6d's one launch CTA by CTA: (T, n) int16 outputs. spans: per
    (tile, lane) the pool words each window may read, ((r_lo, r_hi),
    (e_lo, e_hi)) arrays of shape (T, B); a word outside is poisoned.
    None: the windows' clamps alone (words from each window's start to
    its last). Checks every load, every table slot and every output."""
    pool = np.asarray(pool).view(np.uint32).astype(np.uint64)
    W = len(pool)
    T, B = x0.shape
    u = lambda a: np.asarray(a).view(np.uint32).astype(np.uint64)
    base, rans_end, extras_off = u(base), u(rans_end), u(extras_off)
    x0, rbyte, ebit = u(x0), u(rbyte), u(ebit)
    out = np.zeros((T, n), np.int64)
    writes = np.zeros((T, n), np.int64)
    threads, launch = ctas(T, B, sms)
    for tile, lanes in launch:
        table, stores = build_table(np.asarray(freq)[tile], threads)
        assert (stores == 1).all()
        if not len(lanes):
            continue
        b = base[tile]
        rb, eb = rbyte[tile, lanes], ebit[tile, lanes]
        rend = rans_end[tile]
        rlast = b + (rend - np.uint64(1)) // np.uint64(4) if rend > 0 else b
        r_start = b + rb // np.uint64(4)
        ebits = extras_off[tile] * np.uint64(8) + eb
        e_start = b + (ebits >> np.uint64(5))
        last_r = np.full_like(rb, min(rlast, np.uint64(W - 1)))
        last_e = np.full_like(rb, np.uint64(W - 1))
        if spans is None:
            allowed = ((np.minimum(r_start, last_r), last_r), (np.minimum(e_start, last_e), last_e))
        else:
            (r_lo, r_hi), (e_lo, e_hi) = spans
            allowed = ((r_lo[tile, lanes], r_hi[tile, lanes]),
                       (e_lo[tile, lanes], e_hi[tile, lanes]))

        def reader(lo, hi, last):
            def read(idx, live=None):
                live = np.ones(idx.shape, bool) if live is None else live
                assert (idx[live] <= last[live]).all() and (idx[live] < W).all()
                v = pool[np.minimum(idx, W - 1).astype(np.int64)]
                ok = (idx >= lo) & (idx <= hi)
                return np.where(ok, v, POISON ^ idx)
            return read

        r = Window(reader(*allowed[0], last_r), r_start, (rb & np.uint64(3)) * np.uint64(8), last_r)
        e = Window(reader(*allowed[1], last_e), e_start, ebits & np.uint64(31), last_e)
        rleft = rend.astype(np.int64) - rb.astype(np.int64)
        rbits = 8 * np.clip(rleft, -1, 1 << 24)
        x = x0[tile, lanes]
        # each lane's 128 outputs
        rows = np.full((len(lanes), BLOCK), -1, np.int64)
        for g in range(BLOCK // GROUP):
            for j in range(0, GROUP, 2):
                for second in (False, True):
                    x, rbits, v = _step(x, rbits, r, e, table, second)
                    rows[:, g * GROUP + j + second] = v
                r.move()
                e.move()
        # each warp's outputs, a group of sixteen a lane at a time: through
        # the warp's buffer, two 16-byte stores a lane (row src = pass * 16 +
        # lane / 2, its half lane % 2), or two-byte stores of each lane's own
        # where the row is not 16-byte aligned (lanes past the tile's last
        # decode its last lane again, as the kernel's do)
        by_lane = dict(zip(lanes.tolist(), rows))
        for lane0 in sorted({int(l) - int(l) % 32 for l in lanes}):
            length = min(32 * BLOCK, n - lane0 * BLOCK)
            warp = np.stack([by_lane.get(lane0 + i, by_lane[min(lane0 + i, B - 1)])
                             for i in range(32)])
            base_out = lane0 * BLOCK
            vec = (tile * n + base_out) % 8 == 0
            for g in range(BLOCK // GROUP):
                pieces = []
                if vec:
                    for p in range(2):
                        for lane_id in range(32):
                            src, h = p * 16 + lane_id // 2, lane_id % 2
                            o = src * BLOCK + g * GROUP + h * 8
                            pieces.append((o, warp[src, g * GROUP + h * 8:][:8]))
                else:
                    for lane_id in range(32):
                        o = lane_id * BLOCK + g * GROUP
                        pieces.append((o, warp[lane_id, g * GROUP:][:GROUP]))
                for o, vals in pieces:
                    k = max(0, min(len(vals), length - o))
                    out[tile, base_out + o:][:k] = vals[:k]
                    writes[tile, base_out + o:][:k] += 1
    assert (writes == 1).all()
    return (out - ((out & 0x8000) << 1)).astype(np.int16)


# ---------------------------------------------------------------- cases


def _kinds():
    rng = np.random.default_rng(0x2A15)
    photo = (rng.normal(0, 2.2, size=21846) ** 3 / 8).astype(np.int16)
    return {
        "photo": [photo],
        "zeros": [np.zeros(5000, np.int16)],                       # f = 4096
        "fullrange": [rng.integers(-32768, 32768, size=3000).astype(np.int16)],
        "int16min": [np.tile(np.array([-32768, 7, -32768, 0], np.int16), 500)],
        "zero_ends": [rng.integers(1, 200, size=6000).astype(np.int16)],
        "short_100": [photo[:100]],                               # fewer than 128 outputs
        "one_block": [photo[:128]],
        "n_1000": [photo[:1000]],                                 # not a multiple of 128
        "nearly_empty_cta": [photo[: 32 * 128 + 5]],              # a CTA of one lane of 5
        "three_tiles": [photo[:3000], rng.integers(-32768, 32768, size=3000).astype(np.int16),
                        np.resize(np.array([-32768, 7, 0], np.int16), 3000)],
        "misaligned_rows": [photo[i * 1001 : (i + 1) * 1001] for i in range(3)],
        "runs": [np.repeat(rng.integers(-60, 60, size=40).astype(np.int16), 173)],
    }


def _upload(rows, pool_end=False):
    n = rows[0].size
    payloads = [ref_kagari.manba_encode(v, 2 * n + 64) for v in rows]
    items = [(None, p, ref_kagari.manba_sync(n, p, md.DECODE_BLOCK)) for p in payloads]
    buf, T, B = pack_manba_upload(items)
    parts = list(split_manba_upload(torch.from_numpy(buf), T, B))
    if pool_end:  # the pool ends on the last payload's last word
        parts[0] = parts[0][:-DECODE_SLACK_WORDS]
    return parts, items


def _spans(parts, items):
    """Each lane's words: those holding the rANS bytes and the extras bits
    the sync records give it (its block's, up to the next block's records
    or the payload's ends)."""
    _, base, rans_end, extras_off, _, rbyte, ebit, _ = (
        np.asarray(p).view(np.uint32).astype(np.int64) for p in parts)
    T, B = rbyte.shape
    r_end = np.concatenate([rbyte[:, 1:], rans_end[:, None]], axis=1)
    e_total = np.array([(len(p) - e) * 8 for (_, p, _), e in zip(items, extras_off)])
    e_end = np.concatenate([ebit[:, 1:], e_total[:, None]], axis=1)
    b = base[:, None]
    r_lo, r_hi = b + rbyte // 4, b + (r_end - 1) // 4
    e_bits = extras_off[:, None] * 8
    e_lo, e_hi = b + (e_bits + ebit) // 32, b + (e_bits + e_end - 1) // 32
    return ((r_lo.astype(np.uint64), r_hi.astype(np.uint64)),
            (e_lo.astype(np.uint64), e_hi.astype(np.uint64)))


def _ref_decode(items, n):
    """ako_tpu's decoder under JAX, tile by tile."""
    out = []
    fn = jax.jit(ref_md.manba_decode_device, static_argnums=(7, 8, 9, 10))
    for _, p, sy in items:
        words8 = np.zeros(((len(p) + 3) // 4 + 2) * 4, np.uint8)
        words8[: len(p)] = np.frombuffer(p, np.uint8)
        words = jnp.asarray(words8.view(">u4").astype(np.uint32))
        out.append(np.asarray(fn(words, jnp.asarray(sy[0]), jnp.asarray(sy[1]), jnp.asarray(sy[2]),
                                 jnp.asarray(sy[3].astype(np.int32)), sy[5], sy[6], n,
                                 md.DECODE_BLOCK, None, None)))
    return np.stack(out)


@pytest.mark.parametrize("name", list(_kinds()) + ["pool_end"])
def test_emulation(name):
    """K6d emulated with each lane's span alone readable, against the
    coded streams, the plain version and ako_tpu's decoder under JAX."""
    rows = _kinds()["photo" if name == "pool_end" else name]
    n = rows[0].size
    parts, items = _upload(rows, pool_end=name == "pool_end")
    got = emulate(*parts, n, spans=_spans(parts, items))
    np.testing.assert_array_equal(got, np.stack(rows))
    np.testing.assert_array_equal(md.manba_decode_plain(*parts, n).numpy(), got)
    np.testing.assert_array_equal(_ref_decode(items, n), got)
    if name == "nearly_empty_cta":
        _, launch = ctas(*parts[4].shape)
        assert [len(lanes) for _, lanes in launch] == [32, 1]
    if name == "misaligned_rows":
        assert n % 8 != 0


@pytest.mark.parametrize("case", ["rans_end_0", "rans_end_short", "ebit_far"])
def test_emulation_odd_records(case):
    """Records no sync scan gives, decoded by the windows' clamps alone
    as the plain version decodes them (and, with both windows inside the
    pool, as ako_tpu's decoder does): no rANS byte left (rans_end = 0),
    rANS bytes that run out inside a lane, and extras cursors that run
    past the pool's end."""
    rows = _kinds()["photo"]
    n = rows[0].size
    parts, _ = _upload(rows)
    pool, base, rans_end, extras_off, x, rbyte, ebit, freq = parts
    if case == "rans_end_0":
        rans_end = torch.zeros_like(rans_end)
    elif case == "rans_end_short":
        rans_end = rbyte[:, 40:41].reshape(-1) + 3
    else:
        ebit = ebit + (pool.shape[0] * 32 - 900)
    parts = (pool, base, rans_end, extras_off, x, rbyte, ebit, freq)
    got = emulate(*parts, n)
    np.testing.assert_array_equal(md.manba_decode_plain(*parts, n).numpy(), got)
    if case != "ebit_far":  # both windows inside the pool: ako_tpu's decoder too
        u = lambda t: jnp.asarray(np.asarray(t).view(np.uint32))
        fn = jax.jit(ref_md.manba_decode_device, static_argnums=(7, 8, 9, 10))
        ref = fn(u(pool), u(x[0]), u(rbyte[0]), u(ebit[0]), jnp.asarray(np.asarray(freq[0])),
                 int(u(rans_end)[0]), int(u(extras_off)[0]), n, md.DECODE_BLOCK, None, None,
                 base=int(base[0]))
        np.testing.assert_array_equal(np.asarray(ref), got[0])

"""The arithmetic around ako_tpu_torch's Kagari kernels, which run only
on the card, held on the CPU to ako_tpu.ops.kagari_device under JAX and
to the host coder (akort.c) with exact equality.

- K3 (csrc/kagari_encode.cu): a numpy emulation of its chunk
  decomposition, launch by launch (each chunk's last mismatch, the
  carried last mismatch and bit offset of a row's earlier chunks, the
  codes packed into a chunk's word buffer, the budget cut, interior
  words stored and the two edge words ORed into the zeroed rows), at
  small chunk sizes so that runs, forced flushes, -32768 and budget cuts
  fall across chunk edges.
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


def emulate_k3(values, budget: int, chunk: int):
    """K3's three launches on (R, n) int16 rows with `chunk` positions a
    CTA. Returns (bytes (R, budget) uint8, totals (R,), per-chunk first
    bit offsets (R, chunks))."""
    values = np.atleast_2d(np.asarray(values, np.int16))
    R, n = values.shape
    chunks = -(-n // chunk)
    row_words = -(-budget // 4)
    out = np.zeros((R, row_words), np.int64)  # launch 1 zeroes the rows
    last_mm = np.full((R, chunks), -1, np.int64)
    bits = np.zeros((R, chunks), np.int64)
    bit0s = np.zeros((R, chunks), np.int64)
    totals = np.zeros(R, np.int64)
    for r, row in enumerate(values.astype(np.int64)):
        for c in range(chunks):  # launch 1: each chunk's last mismatch
            p, same, _ = _positions(row, c, chunk)
            last_mm[r, c] = p[~same].max(initial=-1)
        for c in range(chunks):  # launch 2: each chunk's bits
            bits[r, c] = _chunk_codes(row, c, chunk, last_mm[r, :c].max(initial=-1))[1].sum()
        for c in range(chunks):  # launch 3: carries, pack, store
            vals, nb = _chunk_codes(row, c, chunk, last_mm[r, :c].max(initial=-1))
            bit0 = int(bits[r, :c].sum())
            bit0s[r, c] = bit0
            skip = bit0 & 31
            offs = skip + np.cumsum(nb) - nb
            buf = np.zeros(chunk + 2, np.int64)
            w, s = offs >> 5, offs & 31
            k1 = np.minimum(32 - s, nb)
            k2 = nb - k1
            on, split = nb > 0, k2 > 0
            np.bitwise_or.at(buf, w[on], ((vals >> k2) << (32 - s - k1))[on])
            np.bitwise_or.at(buf, w[split] + 1, ((vals << (32 - k2)) & _U32)[split])
            end = bit0 + int(nb.sum())
            nw = ((end - 1) >> 5) - (bit0 >> 5) + 1 if end > bit0 else 0
            k = np.arange(nw)
            gw = (bit0 >> 5) + k
            keep = gw < row_words  # the budget cut
            edge = ((k == 0) & (skip != 0)) | ((k == nw - 1) & ((end & 31) != 0))
            inner = keep & ~edge
            assert not out[r, gw[inner]].any(), "an interior word is written twice"
            out[r, gw[inner]] = buf[k[inner]]
            out[r, gw[keep & edge]] |= buf[k[keep & edge]]
            totals[r] = (end + 7) >> 3
    by = out.astype(">u4").view(np.uint8).reshape(R, -1)[:, :budget]
    return by, totals, bit0s


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


EDGES = {
    "runs_across_edges": _runs_across_edges,
    "flush_later_chunk": lambda: [7] * (1 + 2 * 65534 + 10),
    "int16_min_at_chunk_starts": _int16_min_at_chunk_starts,
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
    """Full capacity: the emulation's bytes and total equal ako_tpu's,
    the host coder's and the plain version's."""
    v = _stream(name)
    cap = _capacity(v)
    by, totals, _ = emulate_k3(v, cap, chunk)
    ref_by, ref_total = _jax_encode(name, cap, cap)
    assert int(totals[0]) == ref_total
    np.testing.assert_array_equal(by[0], ref_by)
    assert by[0, :ref_total].tobytes() == kagari.kagari_encode(v, cap)
    plain_by, plain_total = kd.kagari_encode_device(torch.from_numpy(v), cap)
    assert int(plain_total) == ref_total
    np.testing.assert_array_equal(by[0], plain_by.numpy())


@pytest.mark.parametrize("chunk", [64, 1000])
@pytest.mark.parametrize("name", ["random_runs", "int16_min_at_chunk_starts"])
def test_k3_budget_cuts(name, chunk):
    """Budgets that cut inside a chunk's words and on a chunk edge (the
    word, and the byte, where chunk 2 begins), and one past the end."""
    v = _stream(name)
    cap = _capacity(v)
    _, _, bit0s = emulate_k3(v, cap, chunk)
    b = int(bit0s[0, 2])
    full = kagari.kagari_encode(v, cap)
    for budget in (b // 8 + 3, (b >> 5) * 4, b // 8, len(full) + 5):
        by, totals, _ = emulate_k3(v, budget, chunk)
        ref_by, ref_total = _jax_encode(name, cap, budget)
        assert int(totals[0]) == ref_total == len(full)
        np.testing.assert_array_equal(by[0], ref_by)
        want = np.zeros(budget, np.uint8)
        m = min(budget, len(full))
        want[:m] = np.frombuffer(full[:m], np.uint8)
        np.testing.assert_array_equal(by[0], want)


def test_k3_batch_of_rows():
    """Rows of different content in one call: each row as ako_tpu codes
    it alone (jax.vmap, its fused encoder's batching), and the host
    coder."""
    rng = np.random.default_rng(0xBA7C)
    n = 3000
    rows = np.stack([
        rng.integers(-3000, 3000, size=n),
        np.zeros(n, np.int64),
        np.repeat(rng.integers(-9, 9, size=n // 30), 30),
        np.where(rng.random(n) < 0.7, 0, rng.integers(-5, 5, size=n)),
    ]).astype(np.int16)
    cap, budget = 4 * n, 2000
    by, totals, _ = emulate_k3(rows, budget, 1000)
    ref_by, ref_total = jax.jit(jax.vmap(lambda x: ref_kd.kagari_encode_device(x, cap, budget)))(
        jnp.asarray(rows))
    np.testing.assert_array_equal(totals, np.asarray(ref_total))
    np.testing.assert_array_equal(by, np.asarray(ref_by))
    for i, row in enumerate(rows):
        full = kagari.kagari_encode(row, cap)
        m = min(budget, len(full))
        assert by[i, :m].tobytes() == full[:m] and not by[i, m:].any()
    plain_by, plain_total = kd.kagari_encode_device(torch.from_numpy(rows), cap, budget)
    np.testing.assert_array_equal(plain_total.numpy(), totals)
    np.testing.assert_array_equal(plain_by.numpy(), by)


def test_k3_layout_and_wrapper():
    """encode_layout's chunks, padded row words and scratch; the wrapper
    takes the plain version on the CPU (no launch counted) and raises on
    a device with no kernel."""
    assert kd.encode_layout(80, 65560, 65558) == (17, 16390, 2 * 80 * 17)
    assert kd.encode_layout(1, 5242932, 5242928) == (1281, 1310732, 2562)
    assert kd.encode_layout(3, kd.K3_CHUNK, 4) == (1, 1, 6)
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
    assert threads * items == kd.K3_CHUNK
    k4 = by_name["kagari_decode.cu"]
    for const, value in (("kLanes", kd.K4_LANES), ("kSpanWords", kd.K4_SPAN_WORDS),
                         ("kBlock", kd.DECODE_BLOCK), ("kSlackWords", kd.DECODE_SLACK_WORDS)):
        assert f"{const} = {value};" in k4

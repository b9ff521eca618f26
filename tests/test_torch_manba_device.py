"""ako_tpu_torch's Manbavaran coder on the device-entropy path, on the
CPU: the plain versions of kernels K6e and K6d (ops/manba_device.py)
against ako_tpu.ops.manba_device under JAX on the CPU and against the
native coder (akort.c), K6e's chain step emulated in Python integers on
its packed table (csrc/manba_encode.cu) against the plain chain, and the
codec with AKO_TPU_MANBAVARAN=1 against ako_tpu's blobs, pixels,
fallback counts and events. Inputs come from numpy seeds; every
comparison is exact equality."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ako_tpu
import ako_tpu_torch
from ako_tpu.ops import manba_device as ref_md
from ako_tpu.runtime import kagari as ref_kagari
from ako_tpu.utils import metrics as ref_metrics
from ako_tpu_torch import Compression, Settings, Wavelet
from ako_tpu_torch.decode import manba_spans, pack_manba_upload, split_manba_upload
from ako_tpu_torch.ops import manba_device as md
from ako_tpu_torch.runtime import kagari
from ako_tpu_torch.utils import metrics
from tests.test_torch_entropy import _ref_settings

port_decode = importlib.import_module("ako_tpu_torch.decode")
port_encode = importlib.import_module("ako_tpu_torch.encode")


def _photo(rng, h, w, ch=3):
    """tests/test_manbavaran.py's smooth image with noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 120 + 60 * np.sin(x / 29.0) + 50 * np.cos(y / 17.0)
    img = np.stack([np.clip(base * (0.6 + 0.1 * c), 0, 255) for c in range(ch)], axis=-1)
    img += rng.normal(0, 3.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _kind(kind):
    """The streams of tests/test_manbavaran.py's device-encoder parity
    test, each from its own seed."""
    rng = np.random.default_rng(0x2A15)
    return {
        "photo": lambda: (rng.normal(0, 2.2, size=21846) ** 3 / 8).astype(np.int16),
        "zeros": lambda: np.zeros(5000, np.int16),
        "fullrange": lambda: rng.integers(-32768, 32768, size=3000).astype(np.int16),
        "int16min": lambda: np.tile(np.array([-32768, 7, -32768, 0], np.int16), 500),
        "single": lambda: np.array([123], np.int16),
        "runs": lambda: np.repeat(rng.integers(-60, 60, size=40).astype(np.int16), 173),
    }[kind]()


def _tile_stream():
    """A lifted and quantized 96x64 RGBA tile's stream (ako_tpu's XLA
    lift), as test_manbavaran.py's test_tile_stream_parity."""
    from ako_tpu.core import geometry
    from ako_tpu.core.settings import Color, Wavelet as RefWavelet, Wrap
    from ako_tpu.ops.colorspace import to_planar_yuv
    from ako_tpu.ops.lifting import forward_tile
    from ako_tpu.ops.quantization import level_qg

    tile = _photo(np.random.default_rng(0x2A15), 96, 64, ch=4)
    sched = geometry.lift_schedule(64, 96)
    qg = level_qg(sched, 4, 16, 0, 1)
    planes = to_planar_yuv(jnp.asarray(tile), Color.YCOCG_Q, False)
    return np.array(forward_tile(planes, sched, RefWavelet.DD137, Wrap.CLAMP, qg))


@functools.lru_cache(maxsize=None)
def _ref_encoder(budget):
    return jax.jit(jax.vmap(lambda v: ref_md.manba_encode_device(v, budget)))


def _ref_encode(rows, budget):
    return [np.asarray(a) for a in _ref_encoder(budget)(jnp.asarray(rows))]


def _port_encode(rows, budget):
    record, rans, extras = md.manba_encode_device(torch.from_numpy(rows), budget)
    return md.unpack_record(record), rans.numpy(), extras.numpy()


def _check_outputs(rows, budget):
    """All seven outputs of the plain K6e equal ako_tpu's (rows up to
    their used lengths); returns the port's outputs."""
    (freq, x, rb, eb, ok), rans, extras = _port_encode(rows, budget)
    r_freq, r_x, r_rrow, r_rb, r_erow, r_eb, r_ok = _ref_encode(rows, budget)
    np.testing.assert_array_equal(freq, r_freq)
    np.testing.assert_array_equal(x, r_x)
    np.testing.assert_array_equal(rb, r_rb)
    np.testing.assert_array_equal(eb, r_eb)
    np.testing.assert_array_equal(ok, r_ok)
    for i in range(len(rows)):
        eused = min((int(eb[i]) + 7) // 8, budget)
        np.testing.assert_array_equal(extras[i, :eused], r_erow[i, :eused])
        if rb[i] <= budget:
            np.testing.assert_array_equal(rans[i, budget - rb[i] :], r_rrow[i, : rb[i]])
    return (freq, x, rb, eb, ok), rans, extras


def _assembled(outputs, i, capacity):
    (freq, x, rb, eb, ok), rans, extras = outputs
    budget = rans.shape[1]
    return kagari.manba_assemble(freq[i], x[i], rans[i, budget - min(rb[i], budget) :], rb[i],
                                 extras[i], eb[i], ok[i], capacity)


@pytest.mark.parametrize("kind", ["photo", "zeros", "fullrange", "int16min", "single", "runs"])
def test_k6e_matches_reference(kind):
    vals = _kind(kind)
    cap = vals.size * 2 + 64
    out = _check_outputs(vals[None], cap)
    ref = ref_kagari.manba_encode(vals, cap)
    assert ref is not None and _assembled(out, 0, cap) == ref
    assert kagari.manba_encode(vals, cap) == ref


def test_k6e_tile_stream():
    stream = _tile_stream()
    cap = stream.size * 2 + 64
    out = _check_outputs(stream[None], cap)
    assert _assembled(out, 0, cap) == ref_kagari.manba_encode(stream, cap)


def test_k6e_batch_of_rows():
    """Three different rows in one call, each coded on its own."""
    n = 3000
    rows = np.stack([_kind("photo")[:n], _kind("fullrange"), np.resize(_kind("int16min"), n)])
    cap = 2 * n + 64
    out = _check_outputs(rows, cap)
    for i, v in enumerate(rows):
        assert _assembled(out, i, cap) == ref_kagari.manba_encode(v, cap)


def test_k6e_budget_cut():
    """A budget the bytes overrun: the counts stay exact, the extras row
    keeps its head, and the framing refuses the tile (host fallback).
    The rANS row keeps the first-emitted bytes (the stream's tail) at its
    end, where ako_tpu's keeps the stream's head: neither is framed."""
    vals = np.random.default_rng(4000).integers(-32768, 32768, size=4000).astype(np.int16)
    out = _check_outputs(vals[None], 64)
    (_, _, rb, _, _), rans, _ = out
    assert rb[0] > 64
    assert _assembled(out, 0, vals.size * 2 + 64) is None
    # the row's 64 bytes are the last 64 of the stream
    full = ref_kagari.manba_encode(vals, vals.size * 2 + 64)
    head = kagari.MANBA_HEAD.size
    tail = np.frombuffer(full, np.uint8)[head + rb[0] - 64 : head + rb[0]]
    np.testing.assert_array_equal(rans[0], tail)


def _ref_model(sym, n):
    f, ok = jax.jit(ref_md.manba_model_device, static_argnums=1)(jnp.asarray(sym), n)
    return np.asarray(f), bool(ok)


@pytest.mark.parametrize("case", ["over_2_20", "tied_maxima", "negative_drift"])
def test_model_matches_reference(case):
    rng = np.random.default_rng(0x4D)
    if case == "over_2_20":
        # hist * 4096 overflows 32 bits: floor(hist * 4096 / n) needs 64
        sym = np.minimum(rng.geometric(0.45, size=1_100_000) - 1, 16).astype(np.int32)
    elif case == "tied_maxima":
        sym = np.repeat(np.array([3, 5, 1, 7], np.int32), [700, 700, 300, 700])
    else:
        # 16 rare symbols bumped to 1 push the sum past 4096
        sym = np.zeros(100_000, np.int32)
        sym[:16] = np.arange(1, 17)
    f, ok = md.manba_model(torch.from_numpy(sym.astype(np.int64)), sym.size)
    r_f, r_ok = _ref_model(sym, sym.size)
    np.testing.assert_array_equal(f.numpy(), r_f)
    assert bool(ok) == r_ok
    assert int(f.sum()) == 4096
    if case == "negative_drift":
        # the drift is settled below symbol 0's floored share
        assert int(r_f[0]) < int(np.sum(sym == 0)) * 4096 // sym.size


def test_sym_extra_matches_reference():
    v = np.concatenate([np.arange(-32768, 32768, 7), [-32768, -1, 0, 1, 32767]]).astype(np.int16)
    sym, extra, code = md.sym_extra(torch.from_numpy(v))
    r_sym, r_extra, r_code = [np.asarray(a) for a in ref_md._sym_extra(jnp.asarray(v))]
    np.testing.assert_array_equal(sym.numpy(), r_sym)
    np.testing.assert_array_equal(extra.numpy(), r_extra)
    np.testing.assert_array_equal(code.numpy(), r_code)


def _k6e_source():
    return open(md.__file__.replace("ops/manba_device.py", "csrc/manba_encode.cu")).read()


@pytest.mark.parametrize("lo", list(range(1, 4097, 256)))
def test_chain_divider_exact(lo):
    """K6e's divider on the state as it comes in: (x >> 8k) // f ==
    umulhi(x, m) >> (l - 1 + 8k), m = ceil(2^(31+l) / f), l = ceil(log2 f),
    for every f of [lo, lo + 256) and every k the chain reaches (k >= 1
    when f = 1), at the multiples of f 2^8k and their neighbours, 2^23,
    2^31 - 1 and random states below 2^31."""
    src = _k6e_source()
    assert "((1ull << (31 + l)) + f - 1) / f" in src and "32 - __clz(f - 1)" in src
    assert "__umulhi(x, t.a.x)" in src and "return e1 ? x2 : (e0 ? x1 : x0);" in src
    assert "mad(hi >> t.b.y, t.a.w, x + t.b.x)" in src and "mad(hi >> t.b.w, t.a.w, (x >> 16) + t.b.x)" in src
    assert "constexpr int kFlushWarps = kWarps - 1;" in src and "kWarps = kThreads / 32" in src
    assert "constexpr int kThreads = 128;" in src
    assert "make_uint4(cum, l - (l > 0), l + 7, l + 15)" in src
    for f in range(lo, lo + 256):
        l = (f - 1).bit_length() if f > 1 else 0
        m = ((1 << (31 + l)) + f - 1) // f
        assert m < 1 << 32
        for k in range(0 if f > 1 else 1, 3):
            d = f << (8 * k)
            rng = np.random.default_rng(f * 3 + k)
            j = rng.integers(0, (1 << 31) // d + 1, size=200, dtype=np.int64)
            xs = np.concatenate([j * d, j * d - 1, j * d + d - 1,
                                 rng.integers(0, 1 << 31, size=200), [1 << 23, (1 << 31) - 1]])
            xs = xs[(xs >= 0) & (xs < 1 << 31)].astype(np.uint64)
            q = ((xs * np.uint64(m)) >> np.uint64(32)) >> np.uint64(l - 1 + 8 * k)
            np.testing.assert_array_equal(q, (xs >> np.uint64(8 * k)) // np.uint64(f))


# K6e's chain in Python integers, on its table entries as the kernel
# packs them (csrc/manba_encode.cu table_entry, chain_step, run_chunk),
# and its bytes placed as warps 1-3 place them (flush_chunk)

K6_FLUSH_THREADS = 96


def _entry(f, cum):
    l = (f - 1).bit_length() if f > 1 else 0
    m = ((1 << (31 + l)) + f - 1) // f
    z = f << 27 if f < 32 else 0xFFFFFFFF
    return (m, f << 19, z, 4096 - f), (cum, l - (l > 0), l + 7, l + 15)


def _step(x, t):
    """chain_step: the state after the step at state x."""
    (m, y, z, gain), (cum, s0, s1, s2) = t
    hi = (x * m) >> 32
    e0, e1 = x >= y, x >= z
    assert e0 or y != 1 << 19  # f = 1 always renorms
    s = s2 if e1 else s1 if e0 else s0
    add = (x >> 16 if e1 else x >> 8 if e0 else x) + cum
    x = (hi >> s) * gain + add
    assert x < 1 << 31
    return x


def _emitted(x, t):
    return int(x >= t[0][1]) + int(x >= t[0][2])


def _flush(xs, ts, row, end):
    """flush_chunk: the bytes of one chunk's steps (xs: the states
    entering them, ts: their entries) into row downward from end, each of
    96 threads placing its run of positions after a suffix scan of the
    runs' counts; returns the chunk's byte count."""
    n = len(xs)
    run = -(-n // K6_FLUSH_THREADS)
    ks = [_emitted(x, t) for x, t in zip(xs, ts)]
    runs = [(min(n, t * run), min(n, t * run + run)) for t in range(K6_FLUSH_THREADS)]
    counts = [sum(ks[lo:hi]) for lo, hi in runs]
    for t, (lo, hi) in enumerate(runs):
        pos = end - 1 - sum(counts[t + 1:])
        for i in range(hi - 1, lo - 1, -1):
            if ks[i] >= 1 and pos >= 0:
                row[pos] = xs[i] & 0xFF
            if ks[i] == 2 and pos >= 1:
                row[pos - 1] = (xs[i] >> 8) & 0xFF
            pos -= ks[i]
    return sum(counts)


def _emulate_chain(values, freq, budget):
    """One stream through K6e's chain chunk by chunk, back to front:
    (final state, byte count, the rANS row of `budget` bytes)."""
    cum = np.concatenate([[0], np.cumsum(freq)[:-1]]).tolist()
    # an absent symbol (f = 0) never reaches the chain; its entry has f = 1
    tab = [_entry(max(int(f), 1), int(c)) for f, c in zip(freq, cum)]
    sym = md.sym_extra(torch.from_numpy(values))[0].tolist()
    n, x, end, total = len(sym), md.STATE_LO, budget, 0
    row = [0] * budget
    for c in range((n - 1) // md.K6_CHUNK, -1, -1):
        ts = [tab[s] for s in sym[c * md.K6_CHUNK : (c + 1) * md.K6_CHUNK]]
        xs = [0] * len(ts)
        for i in range(len(ts) - 1, -1, -1):
            xs[i] = x
            x = _step(x, ts[i])
        cnt = _flush(xs, ts, row, end)
        end -= cnt
        total += cnt
    return x, total, bytes(row)


def _step_kinds():
    """Streams through the step's cases: f = 1 symbols, a dominant
    symbol near f = 4096, and symbols of f < 16 (two renorms) beside
    symbols of f >= 32 (chip_smoke.py k6_step_kinds)."""
    rng = np.random.default_rng(0x6E)
    return {
        "f1": np.concatenate([np.zeros(9000, np.int16), np.array([-32768, 20000, 3, 900], np.int16),
                              rng.integers(-3, 4, 9000).astype(np.int16)]),
        "dominant": np.where(rng.random(24000) < 0.0008, 1, 0).astype(np.int16),
        "renorm2": np.where(rng.random(20000) < 0.5, rng.integers(-32768, 32768, 20000),
                            rng.integers(-2, 3, 20000)).astype(np.int16),
    }


@pytest.mark.parametrize("kind", ["photo", "zeros", "fullrange", "int16min", "single", "runs",
                                  "tile", "f1", "dominant", "renorm2", "photo_cut"])
def test_chain_step_emulation(kind):
    """K6e's chain, emulated on its packed table with its bytes placed as
    the flush warps place them, against the plain chain's state, rANS
    row and byte count (photo_cut: a 64-byte budget the bytes overrun)."""
    name = kind.removesuffix("_cut")
    v = (_tile_stream() if name == "tile" else
         _step_kinds()[name] if name in ("f1", "dominant", "renorm2") else _kind(name))
    cap = 64 if kind.endswith("_cut") else 2 * v.size + 64
    record, rans, _ = md.manba_encode_plain(torch.from_numpy(v[None]), cap)
    freq, x, rb, _, _ = md.unpack_record(record)
    if kind == "f1":
        assert (freq[0] == 1).any()
    if kind == "dominant":
        assert freq[0].max() >= 4090
    if kind == "renorm2":
        assert ((freq[0] > 0) & (freq[0] < 16)).any() and (freq[0] >= 32).any()
    got_x, got_count, got_row = _emulate_chain(v, freq[0], cap)
    assert got_x == x[0]
    assert got_count == rb[0]
    keep = min(int(rb[0]), cap)
    assert got_row[cap - keep:] == rans[0, cap - keep:].numpy().tobytes()
    if kind.endswith("_cut"):
        assert rb[0] > cap


@pytest.mark.parametrize("k", [0, 1, 2])
def test_chain_step_thresholds(k):
    """K6e's step on states at both renorm thresholds (f << 19 and
    f << 27) and beside them, for every f where such a state renorms k
    times, against the renorm and the division done as the plain chain
    does them."""
    seen = 0
    for f in range(1, 4097):
        cum = 4096 - f  # the largest a symbol's cum can be
        t = _entry(f, cum)
        y, z = f << 19, f << 27
        for x in (y - 2, y - 1, y, y + 1, z - 1, z, z + 1, 1 << 23, (1 << 31) - 1):
            if not (1 << 23) <= x < 1 << 31 or int(x >= y) + int(x >= z) != k:
                continue
            xr = x >> (8 * k)
            assert _step(x, t) == xr + cum + (xr // f) * (4096 - f), (f, x)
            assert _emitted(x, t) == k
            seen += 1
    assert seen >= 40  # k = 2 only for f < 16


# ---------------------------------------------------------------- decode


def _upload(payloads, n):
    items = [(None, p, kagari.manba_sync(n, p, md.DECODE_BLOCK)) for p in payloads]
    buf, T, B = pack_manba_upload(items)
    return split_manba_upload(torch.from_numpy(buf), T, B), manba_spans(items), items


def _ref_decode(items, n, rspan, espan):
    """ako_tpu's decoder, tile by tile, on the same pool layout."""
    out = []
    for _, p, sy in items:
        words8 = np.zeros(((len(p) + 3) // 4 + 2) * 4, np.uint8)
        words8[: len(p)] = np.frombuffer(p, np.uint8)
        words = jnp.asarray(words8.view(">u4").astype(np.uint32))
        fn = jax.jit(ref_md.manba_decode_device, static_argnums=(7, 8, 9, 10))
        out.append(np.asarray(fn(words, jnp.asarray(sy[0]), jnp.asarray(sy[1]),
                                 jnp.asarray(sy[2]), jnp.asarray(sy[3].astype(np.int32)),
                                 sy[5], sy[6], n, md.DECODE_BLOCK, rspan, espan)))
    return np.stack(out)


@pytest.mark.parametrize("kinds", [("photo",), ("runs",), ("int16min", "fullrange", "single")])
def test_k6d_matches_reference(kinds):
    """The plain K6d against ako_tpu's decoder and the native one, on
    payloads of the kinds (several tiles of one length in one pool)."""
    n = max(_kind(k).size for k in kinds)
    vals = [np.resize(_kind(k), n) for k in kinds]
    payloads = [ref_kagari.manba_encode(v, 2 * n + 64) for v in vals]
    parts, (rspan, espan), items = _upload(payloads, n)
    got = md.manba_decode_device(*parts, n, md.DECODE_BLOCK, rspan, espan).numpy()
    np.testing.assert_array_equal(got, np.stack(vals))
    np.testing.assert_array_equal(got, _ref_decode(items, n, rspan, espan))
    for v, p in zip(vals, payloads):
        np.testing.assert_array_equal(ref_kagari.manba_decode(n, p), v)
    # the whole pool as window gives the same values
    np.testing.assert_array_equal(md.manba_decode_device(*parts, n).numpy(), got)


def test_k6d_tile_stream():
    stream = _tile_stream()
    parts, spans, items = _upload([ref_kagari.manba_encode(stream, stream.size * 2)], stream.size)
    got = md.manba_decode_device(*parts, stream.size, md.DECODE_BLOCK, *spans).numpy()
    np.testing.assert_array_equal(got[0], stream)
    np.testing.assert_array_equal(got, _ref_decode(items, stream.size, *spans))


def test_upload_layout():
    """pack_manba_upload's layout is ako_tpu's _pack_manba_upload's head
    (base, rans_end, extras_off, x, rbyte, ebit, freq), then the pool."""
    from ako_tpu.decode import _pack_manba_upload

    vals = [_kind("runs"), np.resize(_kind("photo"), 6920)]
    payloads = [ref_kagari.manba_encode(v, 2 * v.size + 64) for v in vals]
    items = [(None, p, ref_kagari.manba_sync(v.size, p, md.DECODE_BLOCK))
             for v, p in zip(vals, payloads)]
    buf, T, B = pack_manba_upload(items)
    ref = _pack_manba_upload([(t, p, ("manba", sy)) for t, p, sy in items])[0]
    head = 3 * T + 3 * T * B + 17 * T
    np.testing.assert_array_equal(buf[:head].view(np.uint32), ref[:head])
    words = len(buf) - head
    np.testing.assert_array_equal(buf[head:].view(np.uint32), ref[head : head + words])
    assert not ref[head + words :].any()


# ---------------------------------------------------------------- codec

CODEC = {
    "q16_t64": (lambda: _photo(np.random.default_rng(0x2A15), 96, 64, 4),
                Settings(quantization=16, tiles_dimension=64)),
    "q0_t32": (lambda: _photo(np.random.default_rng(0x2A15), 96, 64, 4),
               Settings(quantization=0, gate=0, tiles_dimension=32)),
    "haar_q16": (lambda: _photo(np.random.default_rng(0x2A15), 96, 64, 4),
                 Settings(quantization=16, wavelet=Wavelet.HAAR)),
    # 64, 64 and 22 px columns, 64, 64 and 2 px rows: four shape groups
    "groups_150x130": (lambda: _photo(np.random.default_rng(0x96), 130, 150, 3),
                       Settings(quantization=16, tiles_dimension=64)),
}

_REFS: dict = {}


def _events(log):
    return lambda tile, total, event, user: log.append((tile, total, int(event)))


def _reference(name, monkeypatch):
    """ako_tpu's host-entropy blob, its device-entropy encode's events and
    counts, its decode's pixels, events and counts (once per case)."""
    if name not in _REFS:
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
        make, s = CODEC[name]
        img = make()
        s = s.replace(compression=Compression.MANBAVARAN)
        rs = _ref_settings(s)
        blob = ako_tpu.encode(img, rs, device_entropy=False)
        enc_ev, dec_ev = [], []
        ref_metrics.reset()
        assert ako_tpu.encode(img, rs, _events(enc_ev), device_entropy=True) == blob
        pix = ako_tpu.decode(blob, _events(dec_ev), device_entropy=True)[0]
        np.testing.assert_array_equal(pix, ako_tpu.decode(blob, device_entropy=False)[0])
        _REFS[name] = (img, s, blob, pix, enc_ev, dec_ev, ref_metrics.fallback_summary())
    return _REFS[name]


@pytest.mark.parametrize("name", list(CODEC))
def test_codec_vs_reference(name, monkeypatch):
    img, s, blob, pix, enc_ev, dec_ev, counts = _reference(name, monkeypatch)
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
    metrics.reset()
    got_enc, got_dec = [], []
    got = ako_tpu_torch.encode(img, s, _events(got_enc), device="cpu", device_entropy=True)
    assert got == blob
    got_pix = ako_tpu_torch.decode(got, _events(got_dec), device="cpu", device_entropy=True)[0]
    np.testing.assert_array_equal(got_pix, pix)
    assert metrics.fallback_summary() == counts
    assert got_enc == enc_ev and got_dec == dec_ev
    if s.quantization == 0:
        np.testing.assert_array_equal(got_pix, img)


def test_decode_goes_through_k6d(monkeypatch):
    """The rANS blob decodes through the Manbavaran decoder, not K4."""
    img, s, blob, pix, *_ = _reference("groups_150x130", monkeypatch)
    calls = {"manba": 0, "kagari": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_decode, "manba_decode_device",
                        count("manba", port_decode.manba_decode_device))
    monkeypatch.setattr(port_decode, "kagari_decode_device",
                        count("kagari", port_decode.kagari_decode_device))
    got = ako_tpu_torch.decode(blob, device="cpu", device_entropy=True)[0]
    np.testing.assert_array_equal(got, pix)
    assert calls == {"manba": 4, "kagari": 0}


def test_reserved_flag_blob_takes_k4(monkeypatch):
    """Without the env a MANBAVARAN blob holds Kagari bytes: its rANS scan
    fails and it decodes through K4's branch, on the device, counted."""
    monkeypatch.delenv("AKO_TPU_MANBAVARAN", raising=False)
    img, s = CODEC["q16_t64"][0](), CODEC["q16_t64"][1].replace(
        compression=Compression.MANBAVARAN)
    blob = ako_tpu_torch.encode(img, s, device="cpu", device_entropy=True)
    assert blob == ako_tpu.encode(img, _ref_settings(s), device_entropy=False)
    calls = []
    orig = port_decode.kagari_decode_device
    monkeypatch.setattr(port_decode, "kagari_decode_device",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    metrics.reset()
    got = ako_tpu_torch.decode(blob, device="cpu", device_entropy=True)[0]
    np.testing.assert_array_equal(got, ako_tpu.decode(blob, device_entropy=False)[0])
    assert len(calls) == 2  # the 64x64 and 64x32 groups
    assert metrics.fallback_summary()[metrics.DEC_DEVICE] == 2


def test_fallback_tile_takes_the_host_coder(monkeypatch):
    """A tile whose record the framing refuses (here marked not ok) is
    coded by the host coder on its stream, counted; the blob stays the
    host path's."""
    img, s, blob, *_ = _reference("groups_150x130", monkeypatch)
    monkeypatch.setenv("AKO_TPU_MANBAVARAN", "1")
    orig = port_encode.manba_encode_device

    def not_ok_first(stream, budget):
        record, rans, extras = orig(stream, budget)
        record = record.clone()
        record[0, md.RECORD["ok"]] = 0
        return record, rans, extras

    monkeypatch.setattr(port_encode, "manba_encode_device", not_ok_first)
    metrics.reset()
    assert ako_tpu_torch.encode(img, s, device="cpu", device_entropy=True) == blob
    c = metrics.fallback_summary()
    # the first tile of each of the four shape groups
    assert (c[metrics.ENC_DEVICE], c[metrics.ENC_HOST_FALLBACK]) == (5, 4)


@pytest.mark.parametrize("cut", [17, 60, 200, -1])
def test_truncated_blobs_raise_like_reference(cut, monkeypatch):
    _, _, blob, *_ = _reference("q16_t64", monkeypatch)
    broken = blob[:cut]
    with pytest.raises(ako_tpu.AkoError) as ref:
        ako_tpu.decode(broken, device_entropy=True)
    with pytest.raises(ako_tpu_torch.AkoError) as got:
        ako_tpu_torch.decode(broken, device="cpu", device_entropy=True)
    assert int(got.value.status) == int(ref.value.status)


def test_wrappers_raise_without_a_kernel():
    """A tensor on a device with no kernel raises; nothing falls back to
    the plain version."""
    v = torch.zeros((1, 8), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        md.manba_encode_device(v, 64)
    with pytest.raises(ValueError, match="no kernel"):
        md.manba_decode_device(*(torch.zeros(k, dtype=torch.int32, device="meta")
                                 for k in ((4,), (1,), (1,), (1,), (1, 1), (1, 1), (1, 1),
                                           (1, 17))), 8)

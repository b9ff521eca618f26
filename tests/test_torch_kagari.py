"""ako_tpu_torch's device Kagari coder (ops/kagari_device.py: the plain
versions of the tokenize/pack torch ops and of kernel K4) against
ako_tpu.ops.kagari_device under JAX on the CPU, on the edge streams of
tests/test_kagari_device.py and tests/test_kagari_device_decode.py.
The port's sync scanner (runtime/kagari.py) is held to ako_tpu's, and
the decoders also to the host decoder (akort.c). Inputs come from
numpy seeds; every comparison is exact equality."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ako_tpu.ops import kagari_device as ref_kd
from ako_tpu.runtime import kagari as ref_kagari
from ako_tpu_torch.ops import kagari_device as kd
from ako_tpu_torch.runtime import kagari
from ako_tpu_torch.utils import metrics


def _random_stream():
    rng = np.random.default_rng(0x6B61)
    v = rng.integers(-300, 300, size=3000)
    pos = 0
    while pos < v.size:  # runs of random lengths, crossing block boundaries
        ln = int(rng.integers(1, 40))
        if rng.random() < 0.5:
            v[pos : pos + ln] = v[pos]
        pos += ln
    return v


def _zero_heavy():
    rng = np.random.default_rng(0x7A)
    v = rng.integers(-4, 5, size=4000)
    v[rng.random(4000) < 0.8] = 0
    return v


STREAMS = {
    "distinct": lambda: np.arange(-100, 100) * 3 + 1,
    "extremes": lambda: [0, 1, -1, 32767, -32767, 5],
    "int16_min_wrap": lambda: [7, -32768, 7, 9],
    "single": lambda: [42],
    "run_of_three": lambda: [4, 4, 4, 8],
    "exact_trigger_only": lambda: [3, 3, 3],
    "short_runs": lambda: sum(([k] * k + [100 + k] for k in range(1, 6)), []),
    "run_at_end": lambda: [1, 2, 3] + [9] * 50,
    "alternating": lambda: [3, -3] * 100,
    "int16_extremes_runs": lambda: [32767] * 600 + [-32767] * 600,
    "flush_boundary": lambda: [7] * (1 + 65534),
    "flush_boundary_plus3": lambda: [7] * (1 + 65534 + 3),
    "two_flushes": lambda: [-2] * (1 + 2 * 65534 + 10),
    "random_runs": _random_stream,
    "zero_heavy": _zero_heavy,
}


@functools.lru_cache(maxsize=None)
def _stream(name):
    return np.asarray(STREAMS[name](), np.int16)


def _capacity(v):
    return max(v.nbytes * 4, 64)


@pytest.mark.parametrize("name", list(STREAMS))
def test_encode_matches_reference(name):
    """tokenize, kagari_encode_device (full capacity and a cut budget)
    and kagari_size_device."""
    v = _stream(name)
    cap = _capacity(v)
    vals, nbits = kd.tokenize(torch.from_numpy(v))
    ref_vals, ref_nbits = jax.jit(ref_kd.tokenize)(jnp.asarray(v))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals).astype(np.int64))
    np.testing.assert_array_equal(nbits.numpy(), np.asarray(ref_nbits))

    by, total = kd.kagari_encode_device(torch.from_numpy(v), cap)
    ref_by, ref_total = jax.jit(ref_kd.kagari_encode_device, static_argnums=1)(jnp.asarray(v), cap)
    assert int(total) == int(ref_total)
    np.testing.assert_array_equal(by.numpy(), np.asarray(ref_by))
    assert int(kd.kagari_size_device(torch.from_numpy(v))) == int(total)
    # and the bytes are the host coder's
    assert by.numpy()[: int(total)].tobytes() == kagari.kagari_encode(v, cap)
    # a cut budget keeps the exact total and the first bytes (the cut
    # itself is held to ako_tpu's in test_pack_bits_matches_reference)
    cut, cut_total = kd.kagari_encode_device(torch.from_numpy(v), cap, 17)
    assert int(cut_total) == int(total)
    np.testing.assert_array_equal(cut.numpy(), by.numpy()[:17])


def test_pack_bits_matches_reference():
    """Random codes of 0..31 bits, packed at full capacity and cut."""
    rng = np.random.default_rng(0x9AC)
    nbits = rng.integers(0, 32, size=2000).astype(np.int32)
    vals = (rng.integers(0, 2**31, size=2000) & ((1 << nbits) - 1)).astype(np.int64)
    for cap in (int(nbits.sum()) // 8 + 8, 301):
        by, total = kd.pack_bits(torch.from_numpy(vals), torch.from_numpy(nbits), cap)
        ref_by, ref_total = jax.jit(ref_kd.pack_bits, static_argnums=2)(
            jnp.asarray(vals.astype(np.uint32)), jnp.asarray(nbits), cap
        )
        assert int(total) == int(ref_total)
        np.testing.assert_array_equal(by.numpy(), np.asarray(ref_by))


def test_encode_batched_rows():
    """A (T, n) batch encodes each row as on its own (jax.vmap in
    ako_tpu's fused encoder)."""
    rng = np.random.default_rng(0xBA7)
    rows = np.stack([np.repeat(rng.integers(-50, 50, size=64), k) for k in (4, 8, 16)][:1] * 3)
    rows[1, 100:180] = 0
    rows[2] = rng.integers(-3000, 3000, size=rows.shape[1])
    rows = rows.astype(np.int16)
    by, total = kd.kagari_encode_device(torch.from_numpy(rows), 1024, 512)
    sizes = kd.kagari_size_device(torch.from_numpy(rows))
    for i, row in enumerate(rows):
        ref_by, ref_total = kd.kagari_encode_device(torch.from_numpy(row), 1024, 512)
        assert int(total[i]) == int(ref_total) == int(sizes[i])
        np.testing.assert_array_equal(by[i].numpy(), ref_by.numpy())


def _words(payload: bytes) -> np.ndarray:
    pad = (-len(payload)) % 4 + 4 * kd.DECODE_SLACK_WORDS
    return np.frombuffer(payload + b"\0" * pad, ">u4").astype(np.uint32)


def _sync_tensors(sync):
    return [torch.from_numpy(np.asarray(a).astype(np.int64).astype(np.int32)[None]) for a in sync[:4]]


# every stream at the production block; a few also at a small block,
# where most lanes start mid-run or mid-trigger
DECODE_CASES = [(name, 128) for name in STREAMS] + [
    (name, 8) for name in ("short_runs", "run_of_three", "run_at_end", "random_runs")
]


@pytest.mark.parametrize("name,block", DECODE_CASES)
def test_decode_matches_reference(name, block):
    """kagari_sync equals ako_tpu's, and kagari_decode_device (whole
    pool and the exact span) equals ako_tpu's and the host decoder."""
    v = _stream(name)
    n = v.size
    cap = n * 2 + 64
    payload = kagari.kagari_encode(v, cap * 4)
    sync = kagari.kagari_sync(n, payload, cap, block)
    ref_sync = ref_kagari.kagari_sync(n, payload, cap, block)
    assert sync[4:] == ref_sync[4:]
    for a, b in zip(sync[:4], ref_sync[:4]):
        np.testing.assert_array_equal(a, b)
    host = kagari.kagari_decode(n, payload, cap)
    assert host is not None and host[1] == sync[4]
    # no stream here has codes over 31 bits (the quirk route is
    # test_torch_entropy.py's)
    assert sync[5] <= 31

    words = _words(payload)
    span = kd.decode_span_words(sync[0], len(payload) * 8)
    assert span == ref_kd.decode_span_words(sync[0], len(payload) * 8)
    ref = jax.jit(ref_kd.kagari_decode_device, static_argnums=(5, 6, 7))(
        jnp.asarray(words), *map(jnp.asarray, sync[:4]), n, block, span
    )
    np.testing.assert_array_equal(np.asarray(ref), host[0])
    pool = torch.from_numpy(words.view(np.int32))
    base = torch.zeros(1, dtype=torch.int32)
    for sp in (None, span):
        got = kd.kagari_decode_device(pool, base, *_sync_tensors(sync), n, block, sp)
        np.testing.assert_array_equal(got.numpy()[0], host[0])


def _jumped_runs(v):
    """[start, end) of each RLE run in the host coder's stream of `v`:
    the output values the sync scan jumps. Each group of equal values
    opens with a literal; its next repeats go as literals until
    RLE_TRIGGER, then a length code of at most VALUE_MAX - 1 -
    RLE_TRIGGER values (the forced flush), and so on."""
    out, i, cap = [], 0, kd.VALUE_MAX - 1 - kd.RLE_TRIGGER
    while i < len(v):
        j = i + 1
        while j < len(v) and v[j] == v[i]:
            j += 1
        pos, left = i + 1, j - i - 1
        while left:
            lits = min(left, kd.RLE_TRIGGER)
            pos, left = pos + lits, left - lits
            chunk = min(left, cap)
            if lits == kd.RLE_TRIGGER:
                out.append((pos, pos + chunk))
            pos, left = pos + chunk, left - chunk
        i = j
    return out


def _long_runs():
    """Runs of 300, 1000, 7, 129 and 4000 values between literals."""
    parts = [[11, -5]]
    for k, ln in enumerate((300, 1000, 7, 129, 4000)):
        parts += [[k - 40] * ln, [90 + k, -90 - k]]
    return np.concatenate(parts)


def _run_from(prefix: int, length: int):
    """`prefix` distinct literals, then a run whose jumped part starts at
    output prefix + RLE_TRIGGER + 1 and holds `length` values."""
    return np.concatenate([np.arange(prefix) * 7 - 300,
                           [77] * (1 + kd.RLE_TRIGGER + length), [5, -6]])


def _photo_payload():
    """One whole tile of a corpus.photo image at the tractor's settings
    (akoDefaultSettings: DD 13/7, YCoCg, q 16, one tile), 512x336 RGB."""
    from ako_tpu_torch import Settings, encode
    from ako_tpu_torch.core import container, geometry
    from ako_tpu_torch.decode import tile_block_sizes
    from ako_tpu_torch.utils.corpus import photo

    blob = encode(photo(np.random.default_rng(0x7AC), 512, 336, 3), Settings(), device="cpu")
    view = memoryview(blob)
    ch, w, h, st = container.head_read(view)
    (t,) = geometry.tile_grid(w, h, st.tiles_dimension)
    (size,) = kagari.BLOCK_HEAD.unpack_from(view, container.HEAD_SIZE)
    start = container.HEAD_SIZE + kagari.BLOCK_HEAD.size
    tds, spacing = tile_block_sizes(t, st, ch)
    return tds // 2, bytes(view[start : start + size]), tds + spacing


def _calls(v, blocks, cap=None, count=None):
    """(count, payload, output_capacity_bytes, block) scans of the host
    coder's stream of `v`, one a block."""
    payload = kagari.kagari_encode(v, max(v.nbytes * 4, 64))
    cap = v.size * 2 + 64 if cap is None else cap
    return [(v.size if count is None else count, payload, cap, b) for b in blocks]


def _long_run_calls():
    v = _long_runs()
    assert max(e - s for s, e in _jumped_runs(v)) > 3 * 128
    return _calls(v, [1, 2, 3, 8, 128])


def _boundary_calls(prefix, length, starts):
    """At block 8, a run whose jumped part starts on a boundary and ends
    off one (`starts`), or the other way round."""
    v = _run_from(prefix, length)
    ((s, e),) = _jumped_runs(v)
    assert (s % 8 == 0, e % 8 == 0) == (starts, not starts)
    return _calls(v, [8])


def _last_record_calls():
    v = np.array([1, 2, 3] + [4] * 997)
    ((s, e),) = _jumped_runs(v)
    assert all(s <= (v.size - 1) // b * b < e for b in (8, 128))
    return _calls(v, [8, 128])


def _flush_calls():
    """The forced flush at 65534, with boundaries inside the runs on
    both sides of it."""
    streams = [_stream("flush_boundary_plus3"), _stream("two_flushes")]
    assert all(len(_jumped_runs(v)) > 1 for v in streams)
    return [c for v in streams for c in _calls(v, [8])]


def _overflow_calls():
    """The 4000-value run past the output, and a stream that ends in a
    run one value past it."""
    v = _long_runs()
    ((s, e),) = [r for r in _jumped_runs(v) if r[1] - r[0] == 4000 - 1 - kd.RLE_TRIGGER]
    end = _stream("run_at_end")
    return _calls(v, [8, 128], cap=2 * (e - 10)) + _calls(end, [8], cap=2 * (end.size - 1))


def _short_count_calls():
    """The count ends inside the 4000-value run: the wrap of the
    remaining count."""
    v = _long_runs()
    return _calls(v, [8, 128], count=v.size - 1000)


def _truncation_calls():
    ((count, payload, cap, block),) = _calls(_long_runs(), [8])
    return [(count, payload[:k], cap, block) for k in range(len(payload) + 1)]


def _photo_calls():
    count, payload, cap = _photo_payload()
    return [(count, payload, cap, b) for b in (8, 128)]


# name -> (the scans, whether each succeeds: True, False, or None for
# "as the reference", the first failing and the last succeeding)
SYNC_CASES = {
    "long_runs": (_long_run_calls, True),
    "run_starts_on_boundary": (lambda: _boundary_calls(5, 37, True), True),
    "run_ends_on_boundary": (lambda: _boundary_calls(4, 41, False), True),
    "last_record_in_run": (_last_record_calls, True),
    "flush_b8": (_flush_calls, True),
    "run_overflows_output": (_overflow_calls, False),
    "count_ends_in_run": (_short_count_calls, False),
    "truncations": (_truncation_calls, None),
    "photo_whole_tile": (_photo_calls, True),
}


def _sync_equal(count, payload, cap, block):
    """kagari_sync against ako_tpu's: both None or equal record for
    record, consumed bytes and max_code_bits included; returns the
    port's."""
    got = kagari.kagari_sync(count, payload, cap, block)
    ref = ref_kagari.kagari_sync(count, payload, cap, block)
    assert (got is None) == (ref is None)
    if got is not None:
        assert got[4:] == ref[4:]
        for a, b in zip(got[:4], ref[:4]):
            np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("name", list(SYNC_CASES))
def test_sync_matches_reference(name):
    """kagari_sync equals ako_tpu's, or fails where it fails, on streams
    whose RLE runs the scan jumps across block boundaries."""
    make, ok = SYNC_CASES[name]
    got = [_sync_equal(*c) is not None for c in make()]
    if ok is None:
        assert not got[0] and got[-1]
    else:
        assert got == [ok] * len(got)


@pytest.mark.parametrize("name,runs", [("run_at_end", 47), ("two_flushes", 131072),
                                       ("distinct", 0)])
def test_scan_counters(name, runs):
    """A scan that succeeds adds its count to dec_scan_values and the
    values of the runs it jumped to dec_scan_run_values; one that fails
    adds nothing."""
    v = _stream(name)
    assert sum(e - s for s, e in _jumped_runs(v)) == runs
    payload = kagari.kagari_encode(v, max(v.nbytes * 4, 64))
    metrics.reset()
    assert kagari.kagari_sync(v.size, payload, v.size * 2 + 64, 128) is not None
    assert kagari.kagari_sync(v.size, payload[:1], v.size * 2 + 64, 128) is None
    c = metrics.counters()
    assert c.get(metrics.DEC_SCAN_VALUES, 0) == v.size
    assert c.get(metrics.DEC_SCAN_RUN_VALUES, 0) == runs


def test_decode_many_tiles_in_one_pool():
    """Several payloads in one dense word pool, each from its base word,
    decode in one call as each does alone (the decode path's layout)."""
    rng = np.random.default_rng(0xD0)
    n, block = 1000, 128
    streams = [rng.integers(-40, 40, size=n).astype(np.int16), np.zeros(n, np.int16),
               np.repeat(rng.integers(-9, 9, size=50), 20).astype(np.int16)]
    cap = n * 2 + 64
    payloads = [kagari.kagari_encode(v, cap * 4) for v in streams]
    syncs = [kagari.kagari_sync(n, p, cap, block) for p in payloads]
    bases, pool = [], b""
    for p in payloads:
        bases.append(len(pool) // 4)
        pool += p + b"\0" * ((-len(p)) % 4)
    words = torch.from_numpy(_words(pool).view(np.int32))
    parts = [torch.cat(t) for t in zip(*map(_sync_tensors, syncs))]
    got = kd.kagari_decode_device(words, torch.tensor(bases, dtype=torch.int32), *parts, n, block)
    np.testing.assert_array_equal(got.numpy(), np.stack(streams))


def test_decode_wrapper_devices():
    """A CPU tensor takes the plain version (no launch counted); a
    device without a kernel raises."""
    before = dict(kd.LAUNCHES)
    v = np.array([5, 5, 5, 5, 1], np.int16)
    payload = kagari.kagari_encode(v, 64)
    sync = kagari.kagari_sync(5, payload, 74, kd.DECODE_BLOCK)
    pool = torch.from_numpy(_words(payload).view(np.int32))
    got = kd.kagari_decode_device(pool, torch.zeros(1, dtype=torch.int32), *_sync_tensors(sync), 5)
    np.testing.assert_array_equal(got.numpy()[0], v)
    assert kd.LAUNCHES == before
    meta = [t.to("meta") for t in _sync_tensors(sync)]
    with pytest.raises(ValueError, match="no kernel"):
        kd.kagari_decode_device(pool.to("meta"), torch.zeros(1, dtype=torch.int32), *meta, 5)


def test_constants_match_reference():
    for name in ("RLE_TRIGGER", "VALUE_MAX", "FLUSH_COUNTER", "SYNC_FIRST", "DECODE_BLOCK",
                 "DECODE_SLACK_WORDS"):
        assert getattr(kd, name) == getattr(ref_kd, name)

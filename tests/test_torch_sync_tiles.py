"""The batched Kagari sync scan (runtime/kagari.py kagari_sync_tiles,
akort.c akort_kagari_sync_tiles: an image's tiles in one native call on
native threads) against the per-tile scan, kagari_sync, which
tests/test_torch_kagari.py holds to ako_tpu's; and the counters that say
how often the decode takes it, on the one-device decode and on the
tile-sharded route over a CPU mesh. Streams from numpy seeds; every
comparison is exact. No JAX."""

import zlib

import numpy as np
import pytest
import torch

import ako_tpu_torch
from ako_tpu_torch import Settings
from ako_tpu_torch.core import geometry
from ako_tpu_torch.ops.kagari_device import DECODE_BLOCK
from ako_tpu_torch.parallel import make_mesh
from ako_tpu_torch.parallel import tiles as ptiles
from ako_tpu_torch.runtime import kagari
from ako_tpu_torch.utils import metrics
from ako_tpu_torch.utils.corpus import corpus


def _rle_heavy(rng):
    v = rng.integers(-4, 5, size=3000)
    v[rng.random(3000) < 0.85] = 0
    pos = 0
    while pos < v.size:  # runs of random lengths, crossing block boundaries
        ln = int(rng.integers(1, 300))
        v[pos : pos + ln] = v[pos]
        pos += ln
    return v


def _noisy(rng):
    return rng.integers(-3000, 3000, size=int(rng.integers(200, 2500)))


def _long_run(rng):
    # past the 65534 forced flush of a run's length code
    return np.concatenate([rng.integers(-9, 9, size=40), np.full(70000, 3)])


def _quirk(rng):
    # zigzag(-32768)+1 wraps to a lone 0 bit, which merges with the next
    # literal's 31-bit code into a 33-bit one
    v = rng.integers(-50, 50, size=500)
    at = rng.choice(np.arange(10, 490, 10), size=3, replace=False)
    v[at] = -32768
    v[at + 1] = rng.integers(16384, 32767, size=3)
    return v


# name -> (stream makers, tile by tile, block); each case has more tiles
# than the most threads it runs on, of more than one length
CASES = {
    "rle_heavy": ([_rle_heavy] * 6 + [_long_run] * 3, DECODE_BLOCK),
    "noisy": ([_noisy] * 10, DECODE_BLOCK),
    "mixed_shapes": ([_noisy, _rle_heavy, _long_run, _quirk] * 3, 8),
    "truncated_middle": ([_rle_heavy, _noisy] * 5, DECODE_BLOCK),
    "quirk": ([_quirk, _noisy, _quirk] * 3, DECODE_BLOCK),
}


def _blob(name):
    """One blob of tile payloads at seeded gaps: (blob, offsets, sizes,
    counts, caps, block); the truncated case cuts its middle tile's
    payload short."""
    makers, block = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    parts, offsets, sizes, counts, caps, at = [], [], [], [], [], 0
    for i, make in enumerate(makers):
        v = np.asarray(make(rng), np.int16)
        payload = kagari.kagari_encode(v, v.size * 4 + 64)
        if name == "truncated_middle" and i == len(makers) // 2:
            payload = payload[: len(payload) // 2]
        gap = bytes(rng.integers(0, 256, size=int(rng.integers(0, 9)), dtype=np.uint8))
        parts += [gap, payload]
        offsets.append(at + len(gap))
        sizes.append(len(payload))
        counts.append(v.size)
        caps.append(v.size * 2 + 2 * int(rng.integers(0, 40)))
        at += len(gap) + len(payload)
    return b"".join(parts), offsets, sizes, counts, caps, block


@pytest.mark.parametrize("threads", [1, 2, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_sync_tiles_equal_per_tile_scans(name, threads):
    """Records, consumed bytes and max code bits tile by tile, and the
    values read and jumped (the counters), as kagari_sync gives them one
    tile at a time; a broken tile is None alone."""
    blob, offsets, sizes, counts, caps, block = _blob(name)
    metrics.reset()
    want = [kagari.kagari_sync(c, blob[o : o + n], cap, block)
            for o, n, c, cap in zip(offsets, sizes, counts, caps)]
    want_counts = metrics.counters()
    metrics.reset()
    got = kagari.kagari_sync_tiles(memoryview(blob), offsets, sizes, counts, caps, block, threads)
    got_counts = metrics.counters()

    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert g[4:] == w[4:]
            for a, b in zip(g[:4], w[:4]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    broken = [i for i, w in enumerate(want) if w is None]
    if name in ("quirk", "mixed_shapes"):
        # the wrap can also desync a stream into broken input, as it does
        # the reference's decoder
        assert any(w[5] > 31 for w in want if w is not None)
    else:
        assert broken == ([len(want) // 2] if name == "truncated_middle" else [])
    if name in ("rle_heavy", "mixed_shapes"):
        assert want_counts[metrics.DEC_SCAN_RUN_VALUES] > 0
    for key in (metrics.DEC_SCAN_VALUES, metrics.DEC_SCAN_RUN_VALUES):
        assert got_counts.get(key, 0) == want_counts.get(key, 0)
    assert got_counts[metrics.DEC_SCAN_BATCHES] == 1
    assert got_counts[metrics.DEC_SCAN_BATCH_TILES] == len(want)


def test_sync_tiles_refuses_payloads_outside_the_blob():
    blob, offsets, sizes, counts, caps, block = _blob("noisy")
    sizes[-1] += 1
    with pytest.raises(ValueError, match="outside the blob"):
        kagari.kagari_sync_tiles(blob, offsets, sizes, counts, caps, block, 2)
    assert kagari.kagari_sync_tiles(blob, [], [], [], [], block, 4) == []


def _mesh(n):
    return make_mesh((n,), ("tiles",), devices=[torch.device("cpu")] * n)


@pytest.mark.parametrize("route", ["decode", "sharded"])
def test_one_batched_scan_a_decode(route):
    """A Kagari image's scans are one native call a decode, over all its
    tiles, on the one-device decode and on the tile-sharded route."""
    img = corpus(71, 1, 40, 56, 3)[0]
    s = Settings(quantization=16, tiles_dimension=16)
    blob = ako_tpu_torch.encode(img, s, device="cpu", device_entropy=True)
    n_tiles = len(geometry.tile_grid(56, 40, 16))
    want = ako_tpu_torch.decode(blob, device="cpu")[0]
    metrics.reset()
    for _ in range(2):
        if route == "decode":
            got = ako_tpu_torch.decode(blob, device="cpu", device_entropy=True)[0]
        else:
            got = ptiles.decode_image_sharded(blob, _mesh(3), device_entropy=True)[0]
        np.testing.assert_array_equal(got, want)
    c = metrics.counters()
    assert n_tiles == 12
    assert (c[metrics.DEC_SCAN_BATCHES], c[metrics.DEC_SCAN_BATCH_TILES]) == (2, 2 * n_tiles)
    assert c[metrics.DEC_DEVICE] == 2 * n_tiles

"""Rate control on the CPU: ako_tpu_torch/tools/rate.py and the plain
versions of its device programs (ops/rate_device.py: serialize_plain,
probe_sizes_plain) against ako_tpu/tools/rate.py under JAX, exactly; and
the walks of the K8 kernels' probe table (csrc/rate_common.cuh), emulated
as csrc/rate.cu (K8s) and csrc/kagari_encode.cu rate_sizes (K8p) run
them, against the plain versions.

Images from numpy seeds (utils/corpus.py), 48x64 and 29x33, tiles 0 and
32 (ragged: 32- and 16-px rows of tiles; a 1-px column with no level).
ako_tpu's programs compile once per tile shape, so the tests share few."""

import contextlib
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ako_tpu
from ako_tpu.core import geometry as ref_geometry
from ako_tpu.ops.quantization import level_qg as ref_level_qg
from ako_tpu.tools import rate as ref_rate
from ako_tpu_torch import AkoError, Compression, Settings, Wavelet, Wrap
from ako_tpu_torch.core import geometry
from ako_tpu_torch.encode import tile_qg
from ako_tpu_torch.ops import rate_device as rd
from ako_tpu_torch.ops.kagari_device import K3_CHUNK
from ako_tpu_torch.runtime import kernels
from ako_tpu_torch.tools import rate
from ako_tpu_torch.utils.corpus import corpus

QS = (0, 1, 4, 64, 16384, 65536)


def _ref_settings(s: Settings) -> ako_tpu.Settings:
    ref_default = ako_tpu.Settings()
    return ako_tpu.Settings(**{
        f.name: type(getattr(ref_default, f.name))(int(getattr(s, f.name)))
        for f in dataclasses.fields(Settings)
    })


def _image(h, w, ch, seed=7, noise=0.0):
    img = corpus(seed, 1, h, w, 4)[0][:, :, :ch]
    if noise:
        rng = np.random.default_rng(seed)
        img = np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)
    return np.ascontiguousarray(img)


@contextlib.contextmanager
def _manbavaran(on: bool):
    old = os.environ.get("AKO_TPU_MANBAVARAN")
    os.environ.pop("AKO_TPU_MANBAVARAN", None)
    if on:
        os.environ["AKO_TPU_MANBAVARAN"] = "1"
    try:
        yield
    finally:
        os.environ.pop("AKO_TPU_MANBAVARAN", None)
        if old is not None:
            os.environ["AKO_TPU_MANBAVARAN"] = old


def _groups(img, s: Settings, q: int):
    """(settings at q, per shape group (tw, th, raw, lp, quads)): the
    port's cached raw pyramid and ako_tpu's (lp, quads) of the same
    tiles."""
    enc = rate._CachedEncoder(img, s, device="cpu")
    ref = ref_rate._CachedEncoder(img, _ref_settings(s))
    sq = enc._settings_at(q)
    out = []
    for (tiles, raw), (ref_tiles, lp, quads) in zip(enc._tile_pyramids(sq),
                                                  ref._tile_pyramids(ref._settings_at(q))):
        assert [t.index for t in tiles] == [t.index for t in ref_tiles]
        out.append((tiles[0].w, tiles[0].h, raw, lp, quads))
    return sq, out


def _check_probes(img, s: Settings, qs=QS, gates=(0, 16), chromas=(0, 3)):
    """serialize_plain and probe_sizes_plain on the port's raw pyramid
    equal ako_tpu's _serialize_fn and _probe_sizes_fn on _pyramid_fn's,
    at every (q, gate, chroma_loss)."""
    ch = img.shape[2]
    for gate in gates:
        for q in qs:
            _, groups = _groups(img, s.replace(gate=gate), q)
            for tw, th, raw, lp, quads in groups:
                schedule = geometry.lift_schedule(tw, th)
                levels = len(schedule.levels)
                for chroma in chromas:
                    qg = tile_qg(tw, th, ch, q, gate, chroma)
                    assert qg == ref_level_qg(ref_geometry.lift_schedule(tw, th), ch, q, gate,
                                              chroma)
                    qs_, gs_ = rd.probe_qg(qg, ch)
                    ref_qs = jnp.asarray([list(lv[0]) for lv in qg], dtype=jnp.int16)
                    ref_gs = jnp.asarray([list(lv[1]) for lv in qg], dtype=jnp.int16)
                    want = np.asarray(ref_rate._serialize_fn(tw, th, ch, levels)(
                        lp, quads, ref_qs, ref_gs))
                    got = rd.serialize_plain(raw, schedule, ch, qs_, gs_)
                    np.testing.assert_array_equal(got.numpy(), want, err_msg=f"q {q} g {gate}")
                    sizes = np.asarray(ref_rate._probe_sizes_fn(tw, th, ch, levels)(
                        lp, quads, ref_qs, ref_gs)).astype(np.int64)
                    np.testing.assert_array_equal(
                        rd.probe_sizes_plain(raw, schedule, ch, qs_, gs_).numpy(), sizes)
                    # on the CPU the wrappers are the plain versions
                    assert torch.equal(rd.rate_serialize(raw, schedule, ch, qs_, gs_), got)


@pytest.mark.parametrize("wrap", list(Wrap))
@pytest.mark.parametrize("wavelet", [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR])
def test_serialize_and_sizes_per_wavelet_wrap(wavelet, wrap):
    """Every wavelet x wrap on the 29x33 RGB whole tile, at every q of QS
    but 0 with gate 0 (one colour variant: YCoCg-Q)."""
    img = _image(29, 33, 3)
    s = Settings(wavelet=wavelet, wrap=wrap)
    _check_probes(img, s, qs=QS[1:], gates=(16,))
    _check_probes(img, s, qs=(4, 65536), gates=(0,), chromas=(3,))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_serialize_and_sizes_per_channels(channels):
    """1-4 channels on ragged 32-px tiles of the 48x64 image (two shape
    groups), both colour variants, discard with some zero alphas."""
    img = _image(48, 64, channels)
    if channels in (2, 4):
        img[::3, ::2, -1] = 0
    _check_probes(img, Settings(tiles_dimension=32, discard_non_visible=channels == 4))


def test_serialize_tile_with_no_level():
    """29x33 at 32-px tiles: the 1-px column of tiles has no lift level, its
    stream is the LP planes alone."""
    img = _image(29, 33, 3)
    _, groups = _groups(img, Settings(tiles_dimension=32), 16)
    assert [(tw, th) for tw, th, *_ in groups] == [(32, 29), (1, 29)]
    _check_probes(img, Settings(tiles_dimension=32), qs=(0, 16, 65536), gates=(0,), chromas=(3,))


def test_raw_pyramid_is_identity_lift():
    """The cached raw stream is forward_tiles at q = 1, g = 0: every
    coefficient equal to ako_tpu's unquantized pyramid, heads of 1."""
    img = _image(48, 64, 3)
    _, groups = _groups(img, Settings(), 16)
    ((tw, th, raw, lp, quads),) = groups
    schedule = geometry.lift_schedule(tw, th)
    ones = np.ones((len(schedule.levels), 3), np.int16)
    want = np.asarray(ref_rate._serialize_fn(tw, th, 3, len(schedule.levels))(
        lp, quads, jnp.asarray(ones), jnp.asarray(0 * ones)))
    np.testing.assert_array_equal(raw.numpy(), want)


# ---------------------------------------------------------------- size_at

SIZE_QS = (0, 1, 4, 16, 64, 256, 1024, 16384, 65536)
SIZE_CASES = {
    "whole_rgb": (dict(), 3, False),
    "t32_rgba_gate_chroma": (dict(tiles_dimension=32, gate=16, chroma_loss=3), 4, False),
    "t32_discard": (dict(tiles_dimension=32, discard_non_visible=True), 4, False),
    "t32_manbavaran": (dict(tiles_dimension=32, compression=Compression.MANBAVARAN), 3, True),
    "t32_manbavaran_reserved": (dict(tiles_dimension=32, compression=Compression.MANBAVARAN), 3,
                                False),
}


@pytest.mark.parametrize("case", list(SIZE_CASES))
def test_size_at_matches_jax(case):
    kw, ch, manba = SIZE_CASES[case]
    img = _image(48, 64, ch)
    if ch == 4:
        img[5:20, 7:30, 3] = 0
    s = Settings(**kw)
    with _manbavaran(manba):
        enc = rate._CachedEncoder(img, s, device="cpu")
        ref = ref_rate._CachedEncoder(img, _ref_settings(s))
        for q in SIZE_QS:
            assert enc.size_at(q) == ref.size_at(q), q
            assert enc.encode_at(q) == ref.encode_at(q), q


def _near_capacity_image():
    """29x33 at 32-px tiles has a 1-px column of tiles with no lift level
    (its stream the LP planes, 188 bytes of capacity); full-range noise
    there codes within _CAPACITY_MARGIN of it at q=0 but fits."""
    img = _image(32, 33, 3)
    img[:, 32] = np.random.default_rng(1).integers(0, 256, size=(32, 3))
    return img


def test_size_at_near_capacity_recode():
    """The near-capacity tile is serialized and re-coded on the host in
    both packages, with the same sizes and blobs."""
    from ako_tpu_torch.encode import _CAPACITY_MARGIN
    from ako_tpu_torch.runtime.kagari import BLOCK_HEAD

    img = _near_capacity_image()
    s = Settings(tiles_dimension=32)
    _, groups = _groups(img, s, 0)
    ((_, _, big, _, _), (tw, th, raw, _, _)) = groups
    assert (tw, th) == (1, 32)
    schedule = geometry.lift_schedule(tw, th)
    qs, gs = rd.probe_qg(tile_qg(tw, th, 3, 0, 0, 1), 3)
    (size,) = rd.probe_sizes_plain(raw, schedule, 3, qs, gs).tolist()
    capacity = geometry.tile_data_size(tw, th) * 3 - BLOCK_HEAD.size
    assert capacity - _CAPACITY_MARGIN <= size < capacity
    enc = rate._CachedEncoder(img, s, device="cpu")
    ref = ref_rate._CachedEncoder(img, _ref_settings(s))
    for q in (0, 16):
        assert enc.size_at(q) == ref.size_at(q)
        assert enc.encode_at(q) == ref.encode_at(q)


def test_size_at_incompressible_tile():
    """A 2x2 noise image (no lift level: 12 values in 20 bytes of
    capacity): both raise AkoError, and encode_at gives None in both."""
    img = np.random.default_rng(2).integers(0, 256, size=(2, 2, 3), dtype=np.uint8)
    enc = rate._CachedEncoder(img, Settings(), device="cpu")
    ref = ref_rate._CachedEncoder(img, _ref_settings(Settings()))
    with pytest.raises(ako_tpu.AkoError):
        ref.size_at(16)
    with pytest.raises(AkoError, match="incompressible"):
        enc.size_at(16)
    assert enc.encode_at(16) is None and ref.encode_at(16) is None


# ---------------------------------------------------------------- encode_with_ratio


def _ratio_image():
    return _image(48, 64, 3, seed=11, noise=4.0)


@pytest.mark.parametrize("gate", [0, 16, 24])
@pytest.mark.parametrize("ratio", [0, 1, 2, 4, 8, 12])
def test_encode_with_ratio_matches_jax(ratio, gate, capsys):
    """The blob, the q and the verbose text equal ako_tpu's."""
    img = _ratio_image()
    s = Settings(tiles_dimension=32, gate=gate)
    want = ref_rate.encode_with_ratio(img, _ref_settings(s), ratio, verbose=True)
    ref_out = capsys.readouterr().out
    got = rate.encode_with_ratio(img, s, ratio, verbose=True, device="cpu")
    assert got == want
    assert capsys.readouterr().out == ref_out
    if ratio > 1:
        assert ref_out.startswith("Target: ")


@pytest.mark.parametrize("kw", [dict(wavelet=Wavelet.NONE), dict(compression=Compression.NONE)],
                         ids=["wavelet_none", "compression_none"])
def test_encode_with_ratio_direct_encode(kw):
    """No wavelet or no compression: a direct encode at the settings' q."""
    img = _ratio_image()
    s = Settings(tiles_dimension=32, **kw)
    assert rate.encode_with_ratio(img, s, 8, device="cpu") == ref_rate.encode_with_ratio(
        img, _ref_settings(s), 8)


def test_encode_with_ratio_reuse_quirk(capsys):
    """A size plateau where the last probe ran at another q than the
    chosen one with the same size: both emit the last probe's blob, the
    reference's reuse quirk (ako_tpu/tools/rate.py:341-349). With a gate,
    q = 0 and 4 quantize alike (level_qg gives q = 1 at both), so a
    gradient that codes below the target losslessly ends the descent at
    once on two equal sizes, and the tie picks the ceiling, q = 0; the
    blob is then encoded at q = 4 (the same bytes: the container keeps no
    q)."""
    y, x = np.mgrid[0:48, 0:64]
    img = np.stack([x * 3, y * 4, 128 + x - y], -1).astype(np.uint8)
    s = Settings(gate=16)
    probes, encoded = [], []
    size_at, encode_at = rate._CachedEncoder.size_at, rate._CachedEncoder.encode_at

    def recorded(self, q):
        probes.append((q, size_at(self, q)))
        return probes[-1][1]

    def recorded_encode(self, q):
        encoded.append(q)
        return encode_at(self, q)

    rate._CachedEncoder.size_at = recorded
    rate._CachedEncoder.encode_at = recorded_encode
    try:
        blob, q = rate.encode_with_ratio(img, s, 4, verbose=True, device="cpu")
    finally:
        rate._CachedEncoder.size_at = size_at
        rate._CachedEncoder.encode_at = encode_at
    out = capsys.readouterr().out
    assert q == 0 and [p for p, _ in probes] == [0, 4] and probes[0][1] == probes[1][1]
    assert encoded == [4]
    assert (blob, q) == ref_rate.encode_with_ratio(img, _ref_settings(s), 4, verbose=True)
    assert capsys.readouterr().out == out
    assert blob == rate._CachedEncoder(img, s, "cpu").encode_at(4)


def test_entry_points_need_the_card_unless_cpu():
    """device=None is the CUDA card: with none, the search raises before
    any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    img = _ratio_image()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rate.encode_with_ratio(img, Settings(), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rate._CachedEncoder(img, Settings())


# ---------------------------------------------------------------- the kernels' table walks


def _divt(x: int, q: int) -> int:
    return abs(x) // q * (1 if x >= 0 else -1)


class _Table:
    """csrc/rate_common.cuh's RateTable from a RateArgs, with
    rate_segment, rate_next_segment and rate_value as the kernels run
    them."""

    def __init__(self, a):
        self.n, self.lp, self.segs = a.n, a.lp, a.segs
        self.start = list(a.start[: a.segs]) + [a.n]
        self.q = list(a.q[: a.segs])
        self.g = list(a.g[: a.segs])

    def segment(self, p):
        if p < self.lp:
            return -1
        lo, hi = 0, self.segs - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if self.start[mid] <= p:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def next_segment(self, k, p):
        return k + 1 if k + 1 < self.segs and p + 1 >= self.start[k + 1] else k

    def value(self, k, p, x):
        if k < 0:
            return x
        if p == self.start[k]:
            return self.q[k]
        g = self.g[k]
        return _divt(x, max(self.q[k], 1)) if (x < -g or x > g) else 0


def _emulate_k8s(raw: np.ndarray, t: _Table) -> np.ndarray:
    """csrc/rate.cu: eight values of the flattened rows a thread, the first
    one's segment by search, then steps across row ends (whether the eight
    come by one 16-byte load changes nothing else)."""
    flat = raw.reshape(-1).astype(np.int64)
    out = np.empty_like(flat)
    for i0 in range(0, flat.size, 8):
        p = i0 % t.n
        k = t.segment(p)
        for j in range(min(8, flat.size - i0)):
            out[i0 + j] = t.value(k, p, int(flat[i0 + j]))
            p += 1
            if p == t.n:
                p, k = 0, -1
            else:
                k = t.next_segment(k, p - 1)
    return out.astype(np.int16).reshape(raw.shape)


def _emulate_k8p_stage(raw: np.ndarray, t: _Table):
    """kagari_encode.cu stage_rate, chunk by chunk: the staged values and
    their two neighbours (at a row's ends, the end value with its low bit
    flipped); eight values a thread with steps where the chunk is whole
    and its row position 16-byte aligned, else a search per value."""
    def value(row, p):
        return t.value(t.segment(p), p, int(raw[row, p]))

    rows, n = raw.shape
    chunks = []
    for row in range(rows):
        for start in range(0, n, K3_CHUNK):
            length = min(K3_CHUNK, n - start)
            sv = np.empty(length, np.int64)
            if length == K3_CHUNK and ((row * n + start) * 2) % 16 == 0:
                for u in range(0, K3_CHUNK, 8):
                    p = start + u
                    k = t.segment(p)
                    for j in range(8):
                        sv[u + j] = t.value(k, p, int(raw[row, p]))
                        k = t.next_segment(k, p)
                        p += 1
            else:
                for i in range(length):
                    sv[i] = value(row, start + i)
            before = value(row, start - 1) if start > 0 else value(row, start) ^ 1
            after = value(row, start + length) if start + length < n else value(
                row, start + length - 1) ^ 1
            chunks.append((row, start, sv, before, after))
    return chunks


@pytest.mark.parametrize("shape,tiles", [((48, 64, 4), 0), ((29, 33, 3), 32), ((48, 64, 3), 32)],
                         ids=["whole_4ch_3_chunks", "ragged_no_level", "ragged_2_groups"])
def test_kernel_table_walks(shape, tiles):
    """rate_args' table, and K8s's and K8p's walks over it, against
    serialize_plain: the table's segments in wire order at their (level,
    channel)'s q and g; K8s's output; K8p's staged chunks, neighbours
    and the per-row bit counter (chunks adding in a scrambled order, the
    last writing ceil(bits / 8)) against probe_sizes_plain."""
    from ako_tpu_torch.ops.kagari_device import tokenize

    h, w, ch = shape
    img = _image(h, w, ch)
    rng = np.random.default_rng(9)
    for q, gate, chroma in ((16, 0, 1), (4, 16, 3), (65536, 24, 0)):
        _, groups = _groups(img, Settings(tiles_dimension=tiles, gate=gate, chroma_loss=chroma), q)
        for tw, th, raw, _, _ in groups:
            schedule = geometry.lift_schedule(tw, th)
            qs, gs = rd.probe_qg(tile_qg(tw, th, ch, q, gate, chroma), ch)
            a = rd.rate_args(schedule, ch, qs, gs)
            t = _Table(a)
            lp, starts, lengths, index = rd.segments(schedule, ch)
            assert (a.n, a.lp, a.segs) == (schedule.coeff_count(ch), lp, len(starts))
            assert t.start[:-1] == list(starts) and (not starts or starts[0] == lp)
            assert [e - b for b, e in zip(t.start, t.start[1:])] == list(lengths)
            assert t.q == [int(qs.flat[i]) for i in index]
            assert t.g == [int(gs.flat[i]) for i in index]
            want = rd.serialize_plain(raw, schedule, ch, qs, gs).numpy()
            np.testing.assert_array_equal(_emulate_k8s(raw.numpy(), t), want)

            sizes = {}
            acc = np.zeros(raw.shape[0], np.int64)
            chunks = _emulate_k8p_stage(raw.numpy(), t)
            per_row = np.bincount([c[0] for c in chunks])
            for i in rng.permutation(len(chunks)):
                row, start, sv, before, after = chunks[i]
                np.testing.assert_array_equal(sv, want[row, start : start + len(sv)])
                if start:
                    assert before == want[row, start - 1]
                else:
                    assert before != want[row, 0]
                if start + len(sv) < a.n:
                    assert after == want[row, start + len(sv)]
                else:
                    assert after != want[row, -1]
                # the chunk's bits: the row's tokenizer on its positions
                _, nbits = tokenize(torch.from_numpy(want[row : row + 1]))
                bits = int(nbits.reshape(-1, 2)[start : start + len(sv)].sum())
                old = int(acc[row])
                acc[row] = old + (1 << 40) + bits
                if old >> 40 == per_row[row] - 1:
                    sizes[row] = ((old & ((1 << 40) - 1)) + bits + 7) >> 3
                    acc[row] = 0
            assert not acc.any()
            np.testing.assert_array_equal(
                [sizes[r] for r in range(raw.shape[0])],
                rd.probe_sizes_plain(raw, schedule, ch, qs, gs).numpy())


def test_kernel_table_limits():
    """The table holds every (level, channel) segment of the largest
    tile the format allows at MAX_CHANNELS, within the kernels' 4 KB of
    parameters; the wrappers take only CUDA tensors of the right shape."""
    import ctypes

    from ako_tpu_torch.core.settings import MAX_CHANNELS, MAX_TILES_DIMENSION

    levels = len(geometry.lift_schedule(MAX_TILES_DIMENSION - 1, MAX_TILES_DIMENSION - 1).levels)
    assert levels * MAX_CHANNELS <= kernels.MAX_RATE_SEGS
    assert ctypes.sizeof(kernels.RateArgs) + 64 <= 4096
    src = open(os.path.join(os.path.dirname(kernels.__file__), "..", "csrc",
                            "rate_common.cuh")).read()
    assert f"kRateSegs = {kernels.MAX_RATE_SEGS};" in src
    schedule = geometry.lift_schedule(16, 16)
    qs, gs = rd.probe_qg(tile_qg(16, 16, 3, 16, 0, 1), 3)
    raw = torch.zeros((2, schedule.coeff_count(3)), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rd.rate_sizes(raw, schedule, 3, qs, gs)
    with pytest.raises(ValueError, match="q/g tables"):
        rd.serialize_plain(raw, schedule, 3, qs[:, :2], gs)
    assert rd.identity_qg(schedule, 3)[0] == ((1, 1, 1), (0, 0, 0))

"""Rate control on the CPU: ako_tpu_torch/tools/rate.py and the plain
versions of its device programs (ops/rate_device.py: serialize_plain,
probe_sizes_plain) against ako_tpu/tools/rate.py under JAX, exactly; and
the K8 kernels of csrc/rate.cu emulated as they run (K8s's spans and
loads, K8p's spans, stages, records and row finishers, the closed-form
run bits, the code lengths and the quantizer's multiplier), against the
plain versions and ako_tpu's kagari_size_device.

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


# ---------------------------------------------------------------- the kernels' walks

_RATE_CU = os.path.join(os.path.dirname(kernels.__file__), "..", "csrc", "rate.cu")


def _cu_const(name: str) -> int:
    import re

    return int(re.search(rf"constexpr int {name} = (\d+);", open(_RATE_CU).read()).group(1))


THREADS, ITEMS, RING, LOADS, VEC = (_cu_const(k) for k in
                                    ("kThreads", "kItems", "kRing", "kLoads", "kVec"))
WARPS, STAGE, TILE = THREADS // 32, THREADS * ITEMS, THREADS * VEC * LOADS
SLOT = STAGE + 16
assert "constexpr int kBuf = kRing * kSlot * 2 / 16;" in open(_RATE_CU).read()
BUF = RING * SLOT * 2 // 16  # the finisher's records a pass


class _Table:
    """csrc/rate_common.cuh's RateTable from a RateArgs (entry 0 the LP
    region, entry k + 1 segment k), with rate_entry, rate_body and
    rate_value as the kernels run them: the quantizer by a multiplier
    ceil(2^31 / q) on 2|x|."""

    def __init__(self, a):
        self.n, self.segs = a.n, a.segs
        qs = [1] + list(a.q[: a.segs])
        self.start = [0] + list(a.start[: a.segs]) + [a.n]
        self.mul = [(0x80000000 + max(q, 1) - 1) // max(q, 1) for q in qs]
        self.gate2 = [-2] + [2 * g for g in a.g[: a.segs]]
        self.head = qs

    def entry(self, p):
        lo, hi = 0, self.segs
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            if self.start[mid] <= p:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def body(self, x, e):
        a2 = abs(int(x)) << 1
        f = (a2 * self.mul[e]) >> 32 if a2 > self.gate2[e] else 0
        return -f if x < 0 else f

    def value(self, e, p, x):
        return self.head[e] if e and p == self.start[e] else self.body(x, e)

    def row(self, raw_row: np.ndarray) -> np.ndarray:
        """A row's values at the probe, vectorised (positions' entries by
        search, the same formulas)."""
        p = np.arange(self.n)
        e = np.searchsorted(np.asarray(self.start[:-1]), p, side="right") - 1
        x = raw_row.astype(np.int64)
        a2 = np.abs(x) << 1
        f = np.where(a2 > np.asarray(self.gate2)[e], (a2 * np.asarray(self.mul, np.int64)[e]) >> 32,
                     0)
        v = np.where(x < 0, -f, f)
        heads = np.asarray(self.start[1:-1], np.int64)
        v[heads] = np.asarray(self.head[1:])
        return v


def _emulate_k8s(raw: np.ndarray, t: _Table, ctas: int, mis: int, vec: bool = True) -> np.ndarray:
    """csrc/rate.cu rate_serialize, span by span: each CTA's spans of the
    cut, in tiles of kLoads 16-byte loads a thread (the loads only of whole
    granules inside the span, on the 16-byte route), each thread's entry
    found once and stepped on, the fast route only where its 8 values hold
    no head and no segment's end. Every output written exactly once (the
    rest stays poisoned)."""
    rows, n = raw.shape
    out = np.full(raw.shape, 0x7FFF_0000, np.int64)
    cut = rd.span_cut(rows, n, ctas)
    spans = rows * cut[0]
    assert spans <= max(rows, ctas)
    grid = min(spans, ctas)
    for cta in range(grid):
        for sid in range(cta, spans, grid):
            row, k = divmod(sid, cut[0])
            begin, end, origin = rd.span_bounds(row, k, n, cut, mis)
            assert begin < end and (mis + row * n + origin) % 8 == 0
            src = raw[row].astype(np.int64)
            for tid in range(min(THREADS, -(-(end - origin) // VEC))):
                e = -1
                for g0 in range(origin, end, TILE):
                    for u in range(LOADS):
                        p = g0 + VEC * (u * THREADS + tid)
                        if p >= end:
                            break
                        whole = vec and p >= begin and p + VEC <= end
                        p0 = max(p, begin)
                        if e < 0:
                            e = t.entry(p0)
                        while p0 >= t.start[e + 1]:
                            e += 1
                        if whole and (p > t.start[e] or not e) and p + VEC <= t.start[e + 1]:
                            vals = [t.body(x, e) for x in src[p : p + VEC]]
                            assert (out[row, p : p + VEC] == 0x7FFF_0000).all()
                            out[row, p : p + VEC] = vals
                        else:
                            ee = e
                            for q in range(p0, min(p + VEC, end)):
                                while q >= t.start[ee + 1]:
                                    ee += 1
                                assert out[row, q] == 0x7FFF_0000
                                out[row, q] = t.value(ee, q, src[q])
    assert (out != 0x7FFF_0000).all(), "a value never written"
    return out.astype(np.int16)


def _lit_len(v):
    return rd.lit_len(int(v))


def _emulate_k8p(raw: np.ndarray, t: _Table, ctas: int, mis: int, rng, buf: int = BUF) -> tuple:
    """csrc/rate.cu rate_sizes: the spans of the cut, each CTA's span
    alone and in a scrambled order. A span's stages come through a ring
    slot filled as issue_stage fills it (the copies that hold a position
    of [first - 1, last + 1] of the stage inside the row; every other slot
    poisoned); each thread maps its kItems values and its two neighbours
    (the entry stepped on from the stage before; the route, one entry's
    body, two entries or any, counted a thread: the values are the same
    on each), codes the positions from its first
    mismatch on (none when its warp has no mismatch), and keeps its
    leading positions until the next stage's barrier, when the warps' last
    mismatches give their run's start (run_bits). The span's record goes
    out, the row's counter counts it in, and the row's last span's CTA
    adds every span's leading run in closed form: `buf` records a pass,
    each thread a block of them after the exclusive max of the blocks
    before (a row of 32 spans or fewer: warp 0, a span a lane). Returns
    (sizes, stats)."""
    rows, n = raw.shape
    flat = raw.reshape(-1).astype(np.int64)
    cut = spr, _ = rd.span_cut(rows, n, ctas)
    assert rows * spr <= max(rows, ctas)
    recs, sizes = {}, {}
    count = np.zeros(rows, np.int64)
    stats = dict(skipped_warps=0, warps=0, routes=[0, 0, 0], threads=0, finishers=0,
                 lead_closed=0)

    def thread(first, lo, hi, sv, e):
        """stage_values + stage_thread of one thread: (own bits, Pending as
        a dict, e, mm)."""
        while min(max(first - 1, 0), n - 1) >= t.start[e + 1]:
            e += 1
        raw18 = [int(x) for x in sv]
        route = (0 if first > 0 and first - 1 > t.start[e] and first + ITEMS < t.start[e + 1] else
                 1 if e < t.segs and first + ITEMS < t.start[e + 2] else 2)
        stats["routes"][route] += 1
        if route == 0:
            v = [t.body(x, e) for x in raw18]
        else:
            v, ee = [], e
            for j, x in enumerate(raw18):
                p = first - 1 + j
                if 0 <= p < n:
                    while p >= t.start[ee + 1]:
                        ee += 1
                    v.append(t.value(ee, p, x))
                else:
                    v.append(0)
        if first + lo == 0:
            v[lo] = v[lo + 1] ^ 1
        if first + hi == n:
            v[hi + 1] = v[hi] ^ 1
        mm = 0
        for j in range(lo, hi):
            mm |= (v[j + 1] != v[j]) << j
        pd = dict(fm=first + (mm & -mm).bit_length() - 1 if mm else -1, lead_a=first + lo, v=v[lo + 1],
                  ends=bool(mm) or v[hi + 1] != v[hi], lm=first + mm.bit_length() - 1 if mm else -1)
        pd["lead_b"] = pd["fm"] - 1 if mm else first + hi - 1
        own, last = 0, -64
        for j in range(ITEMS):
            if (mm >> j) & 1:
                last = j
            d = j - last
            b = _lit_len(v[j + 1]) if 0 <= d <= 2 else 0
            if 2 <= d <= 15 and v[j + 2] != v[j + 1]:
                b += 2 * ((d - 1).bit_length() - 1) + 1
            own += b if lo <= j < hi else 0
        return own, pd, e, mm

    def finish(pend, wl, carry, fm_box):
        """finish_stage for every thread: (bits, carry after the stage)."""
        bits = 0
        for tid, pd in enumerate(pend):
            before = max([carry] + wl[: tid // 32])
            m = max(before, pd["excl"])
            if m < 0:
                if pd["fm"] >= 0:
                    assert fm_box[0] == -1
                    fm_box[0] = pd["fm"]
                continue
            if pd["lead_a"] <= pd["lead_b"]:
                bits += rd.run_bits(m, pd["lead_a"], pd["lead_b"], pd["v"], pd["ends"])
                stats["lead_closed"] += 1
        return bits, max([carry] + wl)

    for sid in rng.permutation(rows * spr):
        row, k = divmod(int(sid), spr)
        begin, end, origin = rd.span_bounds(row, k, n, cut, mis)
        assert begin < end and (mis + row * n + origin) % 8 == 0
        stages = -(-(end - origin) // STAGE)
        ring = rng.integers(-32768, 32768, size=(RING, SLOT))  # poisoned
        es = [-1] * THREADS
        carry, fm_box, bits, v0, pend, wl = -1, [-1], 0, None, None, None
        for m in range(stages):
            s0 = origin + m * STAGE
            slot = ring[m % RING]
            slot[:] = rng.integers(-32768, 32768, size=SLOT)
            lo_w, hi_w = max(max(begin, s0) - 1, 0), min(min(end, s0 + STAGE) + 1, n)
            for i in range(SLOT // 8):
                p = s0 - 8 + 8 * i
                if p + 8 <= lo_w or p >= hi_w:
                    continue
                f = row * n + p
                for j in range(8):
                    if 0 <= f + j < flat.size:
                        slot[8 * i + j] = flat[f + j]
            if m:
                b, carry = finish(pend, wl, carry, fm_box)
                bits += b
            pend, wl = [], []
            for w in range(WARPS):
                lanes = []
                for lane in range(32):
                    tid = 32 * w + lane
                    first = s0 + ITEMS * tid
                    lo = max(begin - first, 0)
                    hi = max(min(min(end, s0 + STAGE) - first, ITEMS), lo)
                    if hi == lo:  # no item: nothing coded, kept or published
                        lanes.append((0, dict(fm=-1, lm=-1, lead_a=first + lo,
                                              lead_b=first + lo - 1, v=0, ends=False), 0, 0))
                        continue
                    if es[tid] < 0:
                        es[tid] = t.entry(min(max(first - 1, 0), n - 1))
                    sv = slot[7 + ITEMS * tid : 7 + ITEMS * tid + ITEMS + 2]
                    lanes.append(thread(first, lo, hi, sv, es[tid]))
                    es[tid] = lanes[-1][2]
                    stats["threads"] += 1
                stats["warps"] += 1
                if not any(mm for _, _, _, mm in lanes):
                    stats["skipped_warps"] += 1
                incl = -1
                for own, pd, _, _ in lanes:
                    pd["excl"] = incl
                    incl = max(incl, pd["lm"])
                    bits += own
                    pend.append(pd)
                wl.append(incl)
            if m == 0:
                v0 = pend[0]["v"]
                assert pend[0]["lead_a"] == begin
        b, carry = finish(pend, wl, carry, fm_box)
        bits += b
        if spr == 1:
            assert fm_box[0] == 0
            sizes[row] = (bits + 7) >> 3
            continue
        assert (row, k) not in recs
        recs[row, k] = (fm_box[0], carry, bits, v0)
        count[row] += 1
        if count[row] == spr:  # the row's finisher
            count[row] = 0
            stats["finishers"] += 1
            rr = [recs.pop((row, i)) for i in range(spr)]
            carry, total = -1, 0
            # 32 spans or fewer: warp 0, a span a lane (a pass of one record
            # a thread, the same sums)
            step = buf if spr > 32 else 32
            for c0 in range(0, spr, step):
                cn = min(step, spr - c0)
                per = -(-cn // THREADS)
                blocks = [(min(cn, per * tid), min(cn, per * tid + per)) for tid in range(THREADS)]
                tops = [max([-1] + [rr[c0 + i][1] for i in range(i0, i1)]) for i0, i1 in blocks]
                for tid, (i0, i1) in enumerate(blocks):
                    m = max([carry] + tops[:tid])
                    for i in range(i0, i1):
                        fm, lm, sbits, sv0 = rr[c0 + i]
                        b_i, e_i, _ = rd.span_bounds(row, c0 + i, n, cut, mis)
                        total += sbits
                        if fm != b_i:
                            assert m >= 0
                            next_fm = rr[c0 + i + 1][0] if c0 + i + 1 < spr else -1
                            ends = fm >= 0 or e_i == n or next_fm == e_i
                            total += rd.run_bits(m, b_i, fm - 1 if fm >= 0 else e_i - 1, sv0, ends)
                        m = max(m, lm)
                carry = max([carry] + tops)
            sizes[row] = (total + 7) >> 3
    assert not count.any() and not recs
    return np.asarray([sizes[r] for r in range(rows)], np.int64), stats


def _ref_sizes(values: np.ndarray) -> np.ndarray:
    """ako_tpu's kagari_size_device (JAX), a row at a time."""
    from ako_tpu.ops.kagari_device import kagari_size_device as ref_size

    return np.asarray([int(ref_size(jnp.asarray(r.astype(np.int16)))) for r in values], np.int64)


#: (grid CTAs, int16 offset of the raw base from 16 bytes) for the walks:
#: the card's one-wave grid of 4 CTAs a SM, a grid smaller than the rows,
#: and small grids with unaligned rows
CUTS = [(528, 0), (5, 3), (37, 5), (2, 7)]


@pytest.mark.parametrize("shape,tiles", [((48, 64, 4), 0), ((29, 33, 3), 32), ((48, 64, 3), 32)],
                         ids=["whole_4ch_3_chunks", "ragged_no_level", "ragged_2_groups"])
def test_kernel_table_walks(shape, tiles):
    """rate_args' table, and K8s's and K8p's walks over it, against
    serialize_plain and probe_sizes_plain: the table's segments in wire
    order at their (level, channel)'s q and g; K8s's output under each cut;
    K8p's spans, stages, records and finishers (spans in a scrambled
    order) under each cut."""
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
            assert t.start[1:-1] == list(starts) and (not starts or starts[0] == lp)
            assert [e - b for b, e in zip(t.start[1:], t.start[2:])] == list(lengths)
            assert t.head[1:] == [int(qs.flat[i]) for i in index]
            assert t.gate2[1:] == [2 * int(gs.flat[i]) for i in index]
            want = rd.serialize_plain(raw, schedule, ch, qs, gs).numpy()
            np.testing.assert_array_equal(t.row(raw.numpy()[0])[None], want[:1])
            sizes = rd.probe_sizes_plain(raw, schedule, ch, qs, gs).numpy()
            for ctas, mis in CUTS:
                np.testing.assert_array_equal(_emulate_k8s(raw.numpy(), t, ctas, mis), want)
                got, _ = _emulate_k8p(raw.numpy(), t, ctas, mis, rng)
                np.testing.assert_array_equal(got, sizes, err_msg=f"cut {ctas} {mis}")
    np.testing.assert_array_equal(_emulate_k8s(raw.numpy(), t, 5, 0, vec=False), want)


def _lp_table(n: int, heads=()):
    """A probe table of one row of n values: LP up to the first head, then
    segments at q = 1, g = 0 (the values kept, a head of 1 at each)."""
    a = kernels.RateArgs()
    a.n, a.lp, a.segs = n, heads[0] if heads else n, len(heads)
    a.start[: len(heads)] = list(heads)
    a.q[: len(heads)] = [1] * len(heads)
    a.g[: len(heads)] = [0] * len(heads)
    return a


def _constructed_streams():
    """{name: ((rows, n) int16 raw streams, heads)} that stress the span
    cut: runs of 65534 k +- 1 equal values across span edges (a flush on
    an edge), spans with no mismatch, a row of one value, rows shorter than
    a span, n not a multiple of 8, -32768, and 1, 3, 80, 81 and 200 rows."""
    rng = np.random.default_rng(15)
    k = 65534
    out = {}
    for extra in (-1, 0, 1):
        row = np.concatenate([[5, 6], np.full(2 * k + extra, -3), [7], np.full(k + extra, -32768),
                              rng.integers(-4, 4, 50)])
        out[f"flush_runs_{extra:+d}"] = (row[None].astype(np.int16), ())
    row = np.full(3 * k + 11, 9, np.int16)
    out["one_value"] = (row[None], ())
    row[[0, 70001, 150000]] = -32768
    out["one_value_three_breaks"] = (row[None].copy(), (4097, 131075))
    out["short_rows_3"] = (rng.integers(-2, 3, (3, 37)).astype(np.int16), (5,))
    runs = np.repeat(rng.integers(-3, 3, 1000), rng.integers(1, 300, 1000))[: 80 * 1003]
    out["rows_80"] = (runs.reshape(80, 1003).astype(np.int16), (11, 500))
    out["rows_81"] = (np.repeat(rng.integers(-2, 2, 81 * 65), 7)[: 81 * 453].reshape(81, 453)
                      .astype(np.int16), (3,))
    full = rng.integers(-32768, 32768, (200, 61)).astype(np.int16)
    full[::7, 10:40] = -32768
    out["rows_200_full_range"] = (full, (29,))
    out["rows_1_n_13"] = (np.asarray([[1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3]], np.int16), ())
    return out


CONSTRUCTED = _constructed_streams()


@pytest.mark.parametrize("name", list(CONSTRUCTED))
def test_k8p_walk_constructed(name):
    """K8p's emulation on streams built to stress the span cut, under
    several grids and offsets (so runs, flushes and spans with no mismatch
    fall on span edges differently), against probe_sizes_plain's
    tokenizer and ako_tpu's kagari_size_device under JAX; K8s's too on the
    smaller ones."""
    from ako_tpu_torch.ops.kagari_device import kagari_size_device

    raw, heads = CONSTRUCTED[name]
    t = _Table(_lp_table(raw.shape[1], heads))
    values = np.stack([t.row(r) for r in raw])
    want = kagari_size_device(torch.from_numpy(values.astype(np.int16))).numpy()
    np.testing.assert_array_equal(_ref_sizes(values), want)
    rng = np.random.default_rng(4)
    cuts = [(528, 0), (37, 3), (7, 5)] if raw.size > 100_000 else CUTS + [(1, 1), (900, 6)]
    for ctas, mis in cuts:
        got, stats = _emulate_k8p(raw, t, ctas, mis, rng, buf=BUF if ctas < 500 else 7)
        np.testing.assert_array_equal(got, want, err_msg=f"cut {ctas} {mis}")
        if raw.size < 20_000:
            np.testing.assert_array_equal(_emulate_k8s(raw, t, ctas, mis), values.astype(np.int16))
    if name == "one_value":
        assert stats["skipped_warps"] > 0 and stats["finishers"] == 1


def test_run_bits_closed_form():
    """rate_device.run_bits (csrc/rate.cu's) against the plain tokenizer:
    every run length through two flushes (up to 2 x 65534 + 3) on a run that
    goes on (prefix sums of one long run), and on runs that end there (every
    length to 1500, around each power of two and each flush); pieces of a
    run that start mid-run; literals of 0, 5, 32767 and -32768."""
    from ako_tpu_torch.ops.kagari_device import tokenize

    k = 65534
    top = 2 * k + 3
    for v in (0, 5, 32767, -32768):
        run = torch.full((1, top + 2), v, dtype=torch.int16)
        _, nbits = tokenize(run)
        per = nbits.reshape(-1, 2).sum(dim=1).numpy().astype(np.int64)
        pre = np.cumsum(per)  # pre[b]: positions 0..b; the run never ends before top + 1
        for b in range(1, top + 1):
            assert rd.run_bits(0, 1, b, v, False) == pre[b] - pre[0], (v, b)
        rng = np.random.default_rng(v & 0xFFFF)
        for a, b in np.sort(rng.integers(1, top + 1, (300, 2)), axis=1):
            assert rd.run_bits(0, int(a), int(b), v, False) == pre[b] - pre[a - 1]
        lengths = set(range(1, 1501)) | {2 ** j + d for j in range(11, 17) for d in (-1, 0, 1, 2)}
        lengths |= {k + d for d in range(-3, 5)} | {2 * k + d for d in range(-3, 4)}
        other = 1 if v != 1 else 2
        parts, ends_at = [], []
        pos = 0
        for i, L in enumerate(sorted(lengths)):
            val = v if i % 2 == 0 else other
            parts.append(np.full(L, val, np.int16))
            ends_at.append((pos, pos + L - 1, val))
            pos += L
        stream = torch.from_numpy(np.concatenate(parts)[None])
        _, nbits = tokenize(stream)
        per = nbits.reshape(-1, 2).sum(dim=1).numpy().astype(np.int64)
        pre = np.concatenate([[0], np.cumsum(per)])
        for m, b, val in ends_at:
            if b > m:
                assert rd.run_bits(m, m + 1, b, val, True) == pre[b + 1] - pre[m + 1], (val, b - m)


def test_kernel_code_lengths():
    """csrc/rate.cu's code lengths without __clz: lit_len from a float's
    exponent for every int16 value against the plain tokenizer's literal
    lengths (and rate_device.lit_len), small_gamma_len's table for the
    tokens 1-15."""
    from ako_tpu_torch.ops.kagari_device import _gamma_bits

    src = open(_RATE_CU).read()
    assert "((unsigned)abs(v) << 1 & 0xFFFEu) | 0x4B000001u" in src
    assert "__uint_as_float(m) - 8388608.0f) >> 23) - 253" in src
    assert "u < 8 ? (int)(0x55553310u >> (u << 2) & 15u) : 7" in src
    v = np.arange(-32768, 32768, dtype=np.int64)
    m = (((np.abs(v) << 1) & 0xFFFE) | 0x4B000001).astype(np.uint32)
    e = ((m.view(np.float32) - np.float32(8388608.0)).view(np.int32) >> 23).astype(np.int64)
    u = torch.from_numpy(((((v << 1) ^ (v >> 15)) + 1) & 0xFFFF).astype(np.int32))
    np.testing.assert_array_equal(2 * e - 253, _gamma_bits(u).numpy())
    np.testing.assert_array_equal([rd.lit_len(int(x)) for x in v[::97]], (2 * e - 253)[::97])
    small = [(0x55553310 >> (k << 2) & 15) if k < 8 else 7 for k in range(1, 16)]
    assert small == [2 * (k.bit_length() - 1) + 1 for k in range(1, 16)]


def test_quantizer_multiplier():
    """rate_body's multiplier: 2|x| * ceil(2^31 / q) >> 32 is |x| / q
    truncated for every x of int16 at every q of 1-1024, every 37th q
    after it and 32767."""
    x = np.arange(-32768, 32768, dtype=np.int64)
    a2 = np.abs(x) << 1
    for q in list(range(1, 1025)) + list(range(1025, 32767, 37)) + [32767]:
        mul = (0x80000000 + q - 1) // q
        np.testing.assert_array_equal((a2 * mul) >> 32, np.abs(x) // q, err_msg=f"q {q}")


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

"""ako_tpu_torch.parallel on the CPU against ako_tpu.parallel and
ako_tpu's one-device functions under JAX: the port's mesh is [cpu] x n,
JAX's the 8 virtual CPU devices of tests/conftest.py. The halo path's
streams and reconstructions, the tile path's streams, blobs and pixels
are compared with no tolerance: the contract is bit-exact. Most halo
cases are held to ako_tpu's single-device forward_tile / inverse_tile
(which ako_tpu's own tests equate with its sharded ones), a few to
ako_tpu.parallel's shard_map programs themselves."""

import dataclasses
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ako_tpu
import ako_tpu_torch
from ako_tpu.core import geometry as ref_geometry
from ako_tpu.ops import lifting as ref_lifting
from ako_tpu.ops import wavelets as ref_wavelets
from ako_tpu.ops.quantization import level_qg
from ako_tpu_torch import Settings
from ako_tpu_torch.core import geometry
from ako_tpu_torch.core.settings import Wavelet, Wrap
from ako_tpu_torch.ops import lift_kernels as lk
from ako_tpu_torch.parallel import forward_tile_sharded, halo, inverse_tile_sharded, make_mesh
from ako_tpu_torch.parallel import tiles as ptiles
from ako_tpu_torch.utils import metrics

port_encode = importlib.import_module("ako_tpu_torch.encode")
port_decode = importlib.import_module("ako_tpu_torch.decode")

CPU = torch.device("cpu")
WAVELETS = [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR]
WRAPS = [Wrap.CLAMP, Wrap.MIRROR, Wrap.REPEAT, Wrap.ZERO]


def _mesh(n, axis="rows"):
    return make_mesh((n,), (axis,), devices=[CPU] * n)


def _ref_settings(s: Settings) -> ako_tpu.Settings:
    ref_default = ako_tpu.Settings()
    return ako_tpu.Settings(**{
        f.name: type(getattr(ref_default, f.name))(int(getattr(s, f.name)))
        for f in dataclasses.fields(Settings)
    })


def _ref_forward(planes, w, h, wavelet, wrap, qg):
    """ako_tpu's single-device forward_tile (XLA lift), op by op: the
    cases of one shape share JAX's compiled ops."""
    return np.asarray(ref_lifting.forward_tile(jnp.asarray(planes), ref_geometry.lift_schedule(w, h),
                                               wavelet, wrap, qg, False))


def _ref_inverse(coeffs, w, h, wavelet, wrap, ch):
    return np.asarray(ref_lifting.inverse_tile(jnp.asarray(coeffs), ref_geometry.lift_schedule(w, h),
                                               wavelet, wrap, ch, False))


def _roundtrip(planes, w, h, wavelet, wrap, qg, n):
    """The port's sharded forward and, on ako_tpu's stream, its sharded
    inverse, against ako_tpu's single-device ones."""
    schedule = geometry.lift_schedule(w, h)
    ch = planes.shape[0]
    ref = _ref_forward(planes, w, h, wavelet, wrap, qg)
    got = forward_tile_sharded(torch.from_numpy(planes), schedule, wavelet, wrap, qg, _mesh(n))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = inverse_tile_sharded(torch.from_numpy(ref.copy()), schedule, wavelet, wrap, ch, _mesh(n))
    np.testing.assert_array_equal(back.numpy(), _ref_inverse(ref, w, h, wavelet, wrap, ch))
    return ref


# ---------------------------------------------------------------------
# The halo path


@pytest.mark.parametrize("wavelet,wrap", [(Wavelet.DD137, Wrap.REPEAT), (Wavelet.CDF53, Wrap.MIRROR),
                                          (Wavelet.HAAR, Wrap.CLAMP)],
                         ids=["DD137-REPEAT", "CDF53-MIRROR", "HAAR-CLAMP"])
def test_matches_ako_tpu_sharded(wavelet, wrap):
    """Against ako_tpu.parallel's own shard_map programs on its 8-device
    mesh: a 3-channel 128x128 tile (2 sharded levels)."""
    from ako_tpu import parallel as ref_parallel

    w = h = 128
    rng = np.random.default_rng(int(wavelet) * 4 + int(wrap))
    planes = rng.integers(-512, 512, size=(3, h, w)).astype(np.int16)
    schedule, ref_sched = geometry.lift_schedule(w, h), ref_geometry.lift_schedule(w, h)
    qg = level_qg(ref_sched, 3, 16, 0, 1)
    mesh = ref_parallel.make_mesh((8,), ("rows",))
    ref = np.asarray(jax.jit(lambda p: ref_parallel.forward_tile_sharded(
        p, ref_sched, wavelet, wrap, qg, mesh))(jnp.asarray(planes)))
    got = forward_tile_sharded(torch.from_numpy(planes), schedule, wavelet, wrap, qg, _mesh(8))
    np.testing.assert_array_equal(got.numpy(), ref)
    rec = np.asarray(jax.jit(lambda c: ref_parallel.inverse_tile_sharded(
        c, ref_sched, wavelet, wrap, 3, mesh))(jnp.asarray(ref)))
    back = inverse_tile_sharded(torch.from_numpy(ref.copy()), schedule, wavelet, wrap, 3, _mesh(8))
    np.testing.assert_array_equal(back.numpy(), rec)


@pytest.mark.parametrize("wrap", WRAPS, ids=[w.name for w in WRAPS])
@pytest.mark.parametrize("wavelet", WAVELETS, ids=[w.name for w in WAVELETS])
def test_matches_single_device(wavelet, wrap):
    """Every wavelet x wrap at 128x128, 3 channels, over 8 shards, against
    ako_tpu's forward_tile and inverse_tile."""
    rng = np.random.default_rng(7 + int(wavelet) * 4 + int(wrap))
    planes = rng.integers(-512, 512, size=(3, 128, 128)).astype(np.int16)
    qg = level_qg(ref_geometry.lift_schedule(128, 128), 3, 16, 0, 1)
    _roundtrip(planes, 128, 128, wavelet, wrap, qg, 8)


# (w, h, wavelet, min_sharded) of tests/test_parallel.py's odd dims, each
# under all four wraps, over 8 shards; and ragged levels over 3
ODD = [
    (127, 127, Wavelet.DD137, 2, 8),
    (96, 100, Wavelet.DD137, 2, 8),
    (96, 100, Wavelet.CDF53, 2, 8),
    (96, 100, Wavelet.HAAR, 2, 8),
    (77, 93, Wavelet.DD137, 1, 8),
    (127, 127, Wavelet.CDF53, 2, 8),
    (96, 100, Wavelet.DD137, 3, 3),
]


@pytest.mark.parametrize("wrap", WRAPS, ids=[w.name for w in WRAPS])
@pytest.mark.parametrize("case", ODD, ids=[f"{w}x{h}-{wv.name}-{n}sh" for w, h, wv, _, n in ODD])
def test_odd_and_ragged_levels(case, wrap):
    """Odd sides (fake rows and columns), ragged levels, a last shard
    partial or empty, MIRROR/REPEAT at both ends: at least min_sharded
    levels shard, and the streams and planes are those of ako_tpu's
    native tile codec (ako_tpu.runtime.hostcodec, which ako_tpu's tests
    hold to its XLA lift; one XLA compile per shape and wrap would take
    minutes here)."""
    from ako_tpu.runtime import hostcodec as ref_host

    w, h, wavelet, min_sharded, n = case
    schedule = geometry.lift_schedule(w, h)
    assert sum(halo.plan_levels(schedule, n, wavelet, wrap)) >= min_sharded
    rng = np.random.default_rng(w * h + int(wrap))
    planes = rng.integers(-512, 512, size=(2, h, w)).astype(np.int16)
    qg = level_qg(ref_geometry.lift_schedule(w, h), 2, 16, 0, 1)
    ref = ref_host.tile_lift(planes, wavelet, wrap, qg)
    got = forward_tile_sharded(torch.from_numpy(planes), schedule, wavelet, wrap, qg, _mesh(n))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = inverse_tile_sharded(torch.from_numpy(ref.copy()), schedule, wavelet, wrap, 2, _mesh(n))
    np.testing.assert_array_equal(back.numpy(), ref_host.tile_unlift(ref, w, h, 2, wavelet, wrap))


def test_every_level_sharded_and_none():
    """A thin tile whose one level shards (the LP planes gathered from the
    shards) and a tile too small to shard (the one-device route), against
    ako_tpu's native tile codec."""
    from ako_tpu.runtime import hostcodec as ref_host

    rng = np.random.default_rng(3)
    for w, h, n, want in ((3, 60, 4, 1), (16, 16, 8, 0)):
        schedule = geometry.lift_schedule(w, h)
        assert sum(halo.plan_levels(schedule, n, Wavelet.DD137, Wrap.CLAMP)) == want
        assert want in (0, len(schedule.levels))
        planes = rng.integers(-512, 512, size=(2, h, w)).astype(np.int16)
        qg = level_qg(ref_geometry.lift_schedule(w, h), 2, 16, 0, 1)
        ref = ref_host.tile_lift(planes, Wavelet.DD137, Wrap.CLAMP, qg)
        got = forward_tile_sharded(torch.from_numpy(planes), schedule, Wavelet.DD137, Wrap.CLAMP,
                                   qg, _mesh(n))
        np.testing.assert_array_equal(got.numpy(), ref)
        back = inverse_tile_sharded(got, schedule, Wavelet.DD137, Wrap.CLAMP, 2, _mesh(n))
        np.testing.assert_array_equal(back.numpy(),
                                      ref_host.tile_unlift(ref, w, h, 2, Wavelet.DD137, Wrap.CLAMP))


def test_lossless_roundtrip():
    w = h = 64
    rng = np.random.default_rng(5)
    planes = rng.integers(-255, 256, size=(1, h, w)).astype(np.int16)
    schedule = geometry.lift_schedule(w, h)
    qg = level_qg(ref_geometry.lift_schedule(w, h), 1, 0, 0, 1)
    coeffs = forward_tile_sharded(torch.from_numpy(planes), schedule, Wavelet.CDF53, Wrap.CLAMP, qg,
                                  _mesh(8))
    back = inverse_tile_sharded(coeffs, schedule, Wavelet.CDF53, Wrap.CLAMP, 1, _mesh(8))
    np.testing.assert_array_equal(back.numpy(), planes)


def test_plan_levels_match_ako_tpu():
    """The north-star whole tile and the tractor size over 2, 3, 4 and 8
    shards, every wavelet and wrap; at 8 shards at least 5 and 6 sharded
    levels (tests/test_parallel.py:134-153)."""
    from ako_tpu.parallel import halo as ref_halo

    for (w, h), n, wavelet, wrap in itertools.product(((1024, 1280), (1632, 2464)), (2, 3, 4, 8),
                                                      WAVELETS, WRAPS):
        got = halo.plan_levels(geometry.lift_schedule(w, h), n, wavelet, wrap)
        assert got == ref_halo.plan_levels(ref_geometry.lift_schedule(w, h), n, wavelet, wrap)
    assert sum(halo.plan_levels(geometry.lift_schedule(1024, 1280), 8, Wavelet.DD137,
                                Wrap.CLAMP)) >= 5
    assert sum(halo.plan_levels(geometry.lift_schedule(1632, 2464), 8, Wavelet.DD137,
                                Wrap.CLAMP)) >= 6
    assert halo._MIN_LOCAL_EVENS == ref_halo._MIN_LOCAL_EVENS


def test_shard_pairs():
    """ako_tpu's plan: m = ceil(T / n) pairs a shard, the last ones partial
    or empty."""
    assert halo.shard_pairs(25, 8) == [(0, 4), (4, 8), (8, 12), (12, 16), (16, 20), (20, 24),
                                       (24, 25), (25, 25)]
    assert [p1 - p0 for p0, p1 in halo.shard_pairs(640, 3)] == [214, 214, 212]


# ---------------------------------------------------------------------
# K7's plain versions, level by level

# (h, w, shards): T = 25 over 8 (a one-pair and an empty shard), an odd
# height, a small level where DD 13/7 falls back to CDF 5/3
LEVELS = [(50, 20, 8), (37, 24, 3), (13, 40, 2)]


def _quantize_ref(x, q, g):
    return np.asarray(ref_lifting._quantize_gate(jnp.asarray(x), jnp.asarray(q), jnp.asarray(g)))


@pytest.mark.parametrize("wrap", WRAPS, ids=[w.name for w in WRAPS])
@pytest.mark.parametrize("wavelet", WAVELETS, ids=[w.name for w in WAVELETS])
def test_rows_plain_versions(wavelet, wrap):
    """lift_level_rows_plain / unlift_level_rows_plain on windows cut from
    random planes and streams, with POISON poisoned pairs beyond the
    window on each side, for every shard (first, middle, last, one-pair),
    against ako_tpu's lift2d / unlift2d and _quantize_gate on the whole
    level; an empty shard is refused."""
    poison = 2
    for h, w, n in LEVELS:
        lvl = geometry.LiftLevel(w, h, (w + 1) // 2, (h + 1) // 2)
        T, tw, C = lvl.target_h, lvl.target_w, 2
        schedule = geometry.LiftSchedule(w, h, (lvl,))
        weff = lk.wavelets.effective_wavelet(wavelet, tw, T)
        rng = np.random.default_rng(h * w + int(wavelet) * 4 + int(wrap))
        planes = rng.integers(-32768, 32768, size=(C, h, w)).astype(np.int16)
        qg = ((tuple(int(v) for v in rng.choice([0, 1, 7, 16], C)), (2, 0)),)
        q = np.asarray(qg[0][0], np.int32).reshape(C, 1, 1)
        g = np.asarray(qg[0][1], np.int32).reshape(C, 1, 1)
        ll, b, c, d = (np.asarray(x) for x in ref_wavelets.lift2d(weff, wrap, jnp.asarray(planes), lvl))
        cq, bq, dq = (_quantize_ref(x, q, g) for x in (c, b, d))
        # the inverse: random quantized quadrants whose q heads wrap
        quads = rng.integers(-32768, 32768, size=(4, C, T, tw)).astype(np.int16)
        heads = rng.choice([0, 1, 7, 300, -5], C).astype(np.int16)
        deq = np.where(heads.reshape(1, C, 1, 1) > 1,
                       (quads[1:].astype(np.int64) * heads.reshape(1, C, 1, 1)).astype(np.int16),
                       quads[1:])
        rec = np.asarray(ref_wavelets.unlift2d(weff, wrap, jnp.asarray(quads[0]), jnp.asarray(deq[1]),
                                               jnp.asarray(deq[0]), jnp.asarray(deq[2]), lvl))
        for p0, p1 in halo.shard_pairs(T, n):
            if p0 == p1:
                with pytest.raises(ValueError):
                    lk.lift_level_rows(torch.zeros((C, 2, w), dtype=torch.int16), schedule, 0,
                                       (p0, p1), p0, wavelet, wrap, qg)
                continue
            win_lo, win_n = lk.row_window(T, (p0, p1), weff, wrap)
            lo, wn = win_lo - poison, win_n + 2 * poison
            rows = np.asarray(halo.window_rows(win_lo, win_n, lvl, wrap))
            win = rng.integers(-32768, 32768, size=(C, 2 * wn, w)).astype(np.int16)
            win[:, 2 * poison : 2 * poison + 2 * win_n] = planes[:, rows]
            got_ll, got = lk.lift_level_rows(torch.from_numpy(win), schedule, 0, (p0, p1), lo,
                                             wavelet, wrap, qg)
            np.testing.assert_array_equal(got_ll.numpy(), ll[:, p0:p1])
            want = np.concatenate([q.reshape(C, 1).astype(np.int16)]
                                  + [x[:, p0:p1].reshape(C, -1) for x in (cq, bq, dq)], axis=1)
            np.testing.assert_array_equal(got.numpy(), want.reshape(-1))
            # the inverse's windows: LL and C, B, D rows of the window's
            # pairs, the q heads first, poisoned beyond
            pairs = np.asarray(halo.window_pairs(win_lo, win_n, T, wrap))
            llw = rng.integers(-32768, 32768, size=(C, wn, tw)).astype(np.int16)
            llw[:, poison : poison + win_n] = quads[0][:, pairs]
            cw = rng.integers(-32768, 32768, size=(C, 3, wn, tw)).astype(np.int16)
            cw[:, :, poison : poison + win_n] = quads[1:].transpose(1, 0, 2, 3)[:, :, pairs]
            chunk = np.concatenate([heads.reshape(C, 1), cw.reshape(C, -1)], axis=1).reshape(-1)
            back = lk.unlift_level_rows(torch.from_numpy(llw), torch.from_numpy(chunk), schedule, 0,
                                        (p0, p1), lo, wavelet, wrap)
            np.testing.assert_array_equal(back.numpy(), rec[:, 2 * p0 : min(2 * p1, h)])


def test_rows_window_must_hold_the_halo():
    schedule = geometry.lift_schedule(20, 50)
    qg = level_qg(ref_geometry.lift_schedule(20, 50), 1, 16, 0, 1)
    win = torch.zeros((1, 2 * 6, 20), dtype=torch.int16)
    with pytest.raises(ValueError, match="must hold"):  # pairs [8, 12) need [5, 15)
        lk.lift_level_rows(win, schedule, 0, (8, 12), 6, Wavelet.DD137, Wrap.CLAMP, qg)
    with pytest.raises(ValueError, match="no kernel"):
        lk.lift_level_rows(torch.zeros((1, 20, 20), dtype=torch.int16, device="meta"), schedule, 0,
                           (8, 12), 5, Wavelet.DD137, Wrap.CLAMP, qg)


# ---------------------------------------------------------------------
# The exchange and the mesh


def _ptr(t):
    return t.untyped_storage().data_ptr()


def _spy_launches(monkeypatch):
    """Record every K7 launch of halo.py: (kind, level, shards, source
    storages, output storages), and run it."""
    seen = []
    lift, unlift = lk.lift_level_shards, lk.unlift_level_shards

    def spy_lift(segs, schedule, k, shards, ll, chunk, *a):
        seen.append(("fwd", k, tuple(shards), [_ptr(s.t) for s in segs], [_ptr(ll), _ptr(chunk)]))
        return lift(segs, schedule, k, shards, ll, chunk, *a)

    def spy_unlift(ll_segs, cbd_segs, heads, schedule, k, shards, out, *a):
        seen.append(("inv", k, tuple(shards), [_ptr(s.t) for s in ll_segs + cbd_segs] + [_ptr(heads)],
                     [_ptr(out)]))
        return unlift(ll_segs, cbd_segs, heads, schedule, k, shards, out, *a)

    monkeypatch.setattr(lk, "lift_level_shards", spy_lift)
    monkeypatch.setattr(lk, "unlift_level_shards", spy_unlift)
    return seen


@pytest.mark.parametrize("shape", [(96, 100, 8), (3, 60, 4)], ids=["replicated-top", "all-sharded"])
def test_one_device_reads_and_writes_in_place(shape, monkeypatch):
    """On a one-device mesh (every shard on the CPU) a call copies nothing:
    one launch per sharded level over its non-empty shards; level 0 reads
    the input planes and each later level the LL buffer the level before
    wrote, in place; the forward's chunks are the returned stream's, and
    its last LL is the first replicated level's input or the stream's LP
    head; the inverse reads the stream in place, each level the plane the
    level above wrote, and level 0 writes the returned planes."""
    w, h, n = shape
    seen = _spy_launches(monkeypatch)
    replicated = []
    for name in ("forward_levels", "forward_pyramid"):
        real = getattr(lk, name)
        monkeypatch.setattr(lk, name, lambda x, *a, _real=real: replicated.append(_ptr(x)) or _real(x, *a))
    copies = []
    monkeypatch.setattr(halo, "_copy", lambda *a: copies.append(a))
    before = dict(halo.COPIES)
    rng = np.random.default_rng(11)
    planes = torch.from_numpy(rng.integers(-512, 512, size=(2, h, w)).astype(np.int16))
    schedule = geometry.lift_schedule(w, h)
    qg = level_qg(ref_geometry.lift_schedule(w, h), 2, 16, 0, 1)
    coeffs = forward_tile_sharded(planes, schedule, Wavelet.DD137, Wrap.REPEAT, qg, _mesh(n))
    back = inverse_tile_sharded(coeffs, schedule, Wavelet.DD137, Wrap.REPEAT, 2, _mesh(n))
    np.testing.assert_array_equal(coeffs.numpy(), ako_tpu_torch.ops.lifting.forward_tile(
        planes, schedule, Wavelet.DD137, Wrap.REPEAT, qg).numpy())
    np.testing.assert_array_equal(back.numpy(), ako_tpu_torch.ops.lifting.inverse_tile(
        coeffs, schedule, Wavelet.DD137, Wrap.REPEAT, 2).numpy())
    assert not copies and halo.COPIES == before
    ks = sum(halo.plan_levels(schedule, n, Wavelet.DD137, Wrap.REPEAT))
    fwd = [s for s in seen if s[0] == "fwd"]
    inv = [s for s in seen if s[0] == "inv"]
    want = [(k, tuple(p for p in halo.shard_pairs(schedule.levels[k].target_h, n) if p[0] < p[1]))
            for k in range(ks)]
    assert [s[1:3] for s in fwd] == want and [s[1:3] for s in inv] == want[::-1]
    assert fwd[0][3] == [_ptr(planes)]
    for a, b in zip(fwd, fwd[1:]):
        assert b[3] == [a[4][0]]  # the LL buffer the level before wrote
    assert all(s[4][1] == _ptr(coeffs) for s in fwd)
    if ks == len(schedule.levels):
        assert fwd[-1][4][0] == _ptr(coeffs) and not replicated
    else:
        assert replicated[0] == fwd[-1][4][0]
    for a, b in zip(inv, inv[1:]):
        assert b[3][0] == a[4][0]  # the plane the level above wrote
    assert all(set(s[3][1:]) == {_ptr(coeffs)} for s in inv)
    assert inv[-1][4] == [_ptr(back)]


def test_distinct_devices_copy_only_their_halo_rows(monkeypatch):
    """On a mesh whose alternate shards count as two devices (the grouping
    key monkeypatched), a launch reads only storage of its own device, one
    segment a source, and writes only there; the rows its windows need from
    the other device are copied into its own buffer of that source at their
    own rows, one copy per run of rows of one source part (a shard's rows),
    and the other device's outputs are gathered home one copy per run; the
    stream and planes equal the one-device port's."""
    n, w, h = 8, 96, 100
    mesh = _mesh(n)
    side = {id(s): i % 2 for i, s in enumerate(mesh.shards("rows"))}
    monkeypatch.setattr(halo, "_device_key", lambda s: side[id(s)])
    owner = {}  # storage -> the device (0 or 1) whose buffer it is; others are home's
    kept = []  # every buffer kept alive, so that no storage is reused
    real_empty = halo._empty

    def spy_empty(shard, shape):
        t = real_empty(shard, shape)
        owner[_ptr(t)] = side.get(id(shard), 0)  # the caller's stream: home's
        kept.append(t)
        return t

    monkeypatch.setattr(halo, "_empty", spy_empty)
    copies = []
    real_copy = halo._copy

    def spy_copy(dst, dst_shard, src, src_shard, event, kind):
        copies.append((kind, _ptr(dst), _ptr(src), dst.shape[-2] if dst.dim() < 4 else dst.shape[2]))
        real_copy(dst, dst_shard, src, src_shard, event, kind)

    monkeypatch.setattr(halo, "_copy", spy_copy)
    seen = _spy_launches(monkeypatch)
    rng = np.random.default_rng(12)
    planes = torch.from_numpy(rng.integers(-512, 512, size=(2, h, w)).astype(np.int16))
    schedule = geometry.lift_schedule(w, h)
    wavelet, wrap = Wavelet.DD137, Wrap.MIRROR
    qg = level_qg(ref_geometry.lift_schedule(w, h), 2, 16, 0, 1)
    coeffs = forward_tile_sharded(planes, schedule, wavelet, wrap, qg, mesh)
    n_fwd = len(copies)
    back = inverse_tile_sharded(coeffs, schedule, wavelet, wrap, 2, mesh)
    np.testing.assert_array_equal(coeffs.numpy(), ako_tpu_torch.ops.lifting.forward_tile(
        planes, schedule, wavelet, wrap, qg).numpy())
    np.testing.assert_array_equal(back.numpy(), ako_tpu_torch.ops.lifting.inverse_tile(
        coeffs, schedule, wavelet, wrap, 2).numpy())
    ks = sum(halo.plan_levels(schedule, n, wavelet, wrap))
    assert ks == 2

    def device(k, pairs):
        m = -(-schedule.levels[k].target_h // n)
        return (pairs[0][0] // m) % 2

    for kind, k, shards, srcs, outs in seen:
        d = device(k, shards)
        assert {owner.get(p, 0) for p in srcs + outs} == {d}, f"{kind} level {k}: another's storage"
        assert len(srcs) == (1 if kind == "fwd" else 3)  # a segment a source, and the q heads
        assert all(((p0 // -(-schedule.levels[k].target_h // n)) % 2) == d for p0, _ in shards)
    for kind, dst, src, _ in copies:
        assert owner.get(src, 0) != owner.get(dst, 0), "a copy within one device"
        if kind == "gather":
            assert owner.get(dst, 0) == 0

    def runs(rows, part):
        """Maximal runs of consecutive rows of one source part."""
        rows = sorted(set(rows))
        return sum(1 for i, r in enumerate(rows)
                   if i == 0 or rows[i - 1] != r - 1 or part(rows[i - 1]) != part(r))

    weff = [lk.wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
            for lvl in schedule.levels]
    want_fwd = want_inv = 0
    for k in range(ks):
        lvl = schedule.levels[k]
        T, m = lvl.target_h, -(-lvl.target_h // n)
        m_prev = -(-schedule.levels[k - 1].target_h // n) if k else None
        for d in (0, 1):
            mine = [p for i, p in enumerate(halo.shard_pairs(T, n)) if i % 2 == d and p[0] < p[1]]
            # forward: the window rows held by the other device (level 0's
            # planes are home's), by source shard
            need = {r for pr in mine for r in halo.window_rows(*lk.row_window(T, pr, weff[k], wrap),
                                                                lvl, wrap)}
            held = (lambda r: 0) if k == 0 else (lambda r: (r // m_prev) % 2)
            want_fwd += runs([r for r in need if held(r) != d], lambda r: 0 if k == 0 else r // m_prev)
            # inverse: the LL pairs held by the other device (the top
            # level's are home's), the C, B, D pairs (home's) and the heads
            pneed = {p for pr in mine for p in halo.window_pairs(*lk.row_window(T, pr, weff[k], wrap),
                                                                  T, wrap)}
            m_next = -(-schedule.levels[k + 1].target_h // n) if k + 1 < ks else None
            lheld = (lambda p: 0) if m_next is None else (lambda p: ((p // 2) // m_next) % 2)
            want_inv += runs([p for p in pneed if lheld(p) != d],
                             lambda p: 0 if m_next is None else (p // 2) // m_next)
            if d == 1:
                want_inv += runs(pneed, lambda p: 0) + 1
    got = [c[0] for c in copies]
    assert got[:n_fwd].count("window") == want_fwd and got[n_fwd:].count("window") == want_inv
    # gathers: each of device 1's shards' quadrant rows a level and its last
    # level's LL rows; its level-0 rows back
    odd = lambda k: sum(1 for i, p in enumerate(halo.shard_pairs(schedule.levels[k].target_h, n))
                        if i % 2 and p[0] < p[1])
    assert got[:n_fwd].count("gather") == sum(odd(k) for k in range(ks)) + odd(ks - 1)
    assert got[n_fwd:].count("gather") == odd(0)


def test_more_shards_than_a_launch_takes(monkeypatch):
    """33 shards on one device are refused before any launch; counted as
    two devices (17 and 16 shards) they run, two launches a level, equal
    to the one-device port."""
    n, w, h = 33, 8, 272
    seen = _spy_launches(monkeypatch)
    rng = np.random.default_rng(13)
    planes = torch.from_numpy(rng.integers(-512, 512, size=(1, h, w)).astype(np.int16))
    schedule = geometry.lift_schedule(w, h)
    qg = level_qg(ref_geometry.lift_schedule(w, h), 1, 16, 0, 1)
    mesh = _mesh(n)
    assert halo.plan_levels(schedule, n, Wavelet.CDF53, Wrap.CLAMP)[0]
    with pytest.raises(ValueError, match="at most 32 shards a device"):
        forward_tile_sharded(planes, schedule, Wavelet.CDF53, Wrap.CLAMP, qg, mesh)
    assert not seen
    side = {id(s): i % 2 for i, s in enumerate(mesh.shards("rows"))}
    monkeypatch.setattr(halo, "_device_key", lambda s: side[id(s)])
    coeffs = forward_tile_sharded(planes, schedule, Wavelet.CDF53, Wrap.CLAMP, qg, mesh)
    np.testing.assert_array_equal(coeffs.numpy(), ako_tpu_torch.ops.lifting.forward_tile(
        planes, schedule, Wavelet.CDF53, Wrap.CLAMP, qg).numpy())
    ks = sum(halo.plan_levels(schedule, n, Wavelet.CDF53, Wrap.CLAMP))
    assert [s[1] for s in seen] == [k for k in range(ks) for _ in range(2)]


def test_interleaved_shards_take_one_segment_a_source(monkeypatch):
    """64 shards alternating over two devices (the grouping key
    monkeypatched), 32 a device: every launch of every sharded level takes
    its device's 32 shards and one segment a source, however many runs of
    rows the other device holds, and the stream and planes equal the
    one-device port's."""
    n, w, h = 64, 8, 1024
    mesh = _mesh(n)
    side = {id(s): i % 2 for i, s in enumerate(mesh.shards("rows"))}
    monkeypatch.setattr(halo, "_device_key", lambda s: side[id(s)])
    seen = _spy_launches(monkeypatch)
    rng = np.random.default_rng(14)
    planes = torch.from_numpy(rng.integers(-512, 512, size=(1, h, w)).astype(np.int16))
    schedule = geometry.lift_schedule(w, h)
    wavelet, wrap = Wavelet.DD137, Wrap.REPEAT
    qg = level_qg(ref_geometry.lift_schedule(w, h), 1, 16, 0, 1)
    coeffs = forward_tile_sharded(planes, schedule, wavelet, wrap, qg, mesh)
    back = inverse_tile_sharded(coeffs, schedule, wavelet, wrap, 1, mesh)
    np.testing.assert_array_equal(coeffs.numpy(), ako_tpu_torch.ops.lifting.forward_tile(
        planes, schedule, wavelet, wrap, qg).numpy())
    np.testing.assert_array_equal(back.numpy(), ako_tpu_torch.ops.lifting.inverse_tile(
        coeffs, schedule, wavelet, wrap, 1).numpy())
    ks = sum(halo.plan_levels(schedule, n, wavelet, wrap))
    assert ks == 2
    assert [(s[0], s[1], len(s[2])) for s in seen] == (
        [("fwd", k, 32) for k in range(ks) for _ in range(2)]
        + [("inv", k, 32) for k in reversed(range(ks)) for _ in range(2)])
    assert all(len(s[3]) == (1 if s[0] == "fwd" else 3) for s in seen)


def test_mesh_shapes_and_shards(monkeypatch):
    mesh = make_mesh((2, 4), ("tiles", "rows"), devices=[CPU] * 8)
    assert mesh.shape == {"tiles": 2, "rows": 4} and mesh.size == 8
    assert mesh.axis_devices("rows") == [CPU] * 4 and len(mesh.axis_devices("tiles")) == 2
    rows = mesh.shards("rows")
    assert len(rows) == 4 and len({id(s) for s in rows}) == 4 and mesh.shards("rows") == rows
    # the first line of the other axis: the "tiles" axis's first shard is
    # the "rows" axis's first
    assert mesh.shards("tiles")[0] is rows[0] and all(s.stream is None for s in rows)
    assert make_mesh(devices=[CPU] * 3).shape == {"tiles": 3}
    with pytest.raises(ValueError):
        make_mesh((4,), devices=[CPU] * 3)
    with pytest.raises(ValueError):
        mesh.shards("hosts")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


def test_two_axis_step():
    """One step on a 2 x 4 ("tiles", "rows") mesh as
    __graft_entry__.dryrun_multichip runs it: the tile streams over
    "tiles", a tile's rows over "rows", against the one-device port."""
    mesh = make_mesh((2, 4), ("tiles", "rows"), devices=[CPU] * 8)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(64, 96, 4), dtype=np.uint8)
    s = Settings(quantization=16, tiles_dimension=32)
    got = ptiles.encode_tiles_sharded(img, port_encode.checked_settings(s), mesh)
    want = port_encode.encode_tiles_device(img, port_encode.checked_settings(s), CPU)
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    planes = torch.from_numpy(rng.integers(-512, 512, size=(4, 64, 64)).astype(np.int16))
    schedule = geometry.lift_schedule(64, 64)
    qg = level_qg(ref_geometry.lift_schedule(64, 64), 4, 16, 0, 1)
    stream = forward_tile_sharded(planes, schedule, Wavelet.DD137, Wrap.CLAMP, qg, mesh, "rows")
    np.testing.assert_array_equal(
        stream.numpy(), ako_tpu_torch.ops.lifting.forward_tile(planes, schedule, Wavelet.DD137,
                                                                Wrap.CLAMP, qg).numpy())
    back = inverse_tile_sharded(stream, schedule, Wavelet.DD137, Wrap.CLAMP, 4, mesh, "rows")
    np.testing.assert_array_equal(back.numpy(), ako_tpu_torch.ops.lifting.inverse_tile(
        stream, schedule, Wavelet.DD137, Wrap.CLAMP, 4).numpy())


# ---------------------------------------------------------------------
# The tile path


@pytest.mark.parametrize("shape", [(96, 128, 3), (80, 72, 3)], ids=["regular", "ragged"])
def test_encode_tiles_sharded(shape):
    """Per-tile streams against ako_tpu's encode_tiles_device
    (tests/test_parallel.py:173-193), over 8 shards, 3 and 1."""
    from ako_tpu.encode import checked_settings as ref_checked
    from ako_tpu.encode import encode_tiles_device as ref_tiles

    rng = np.random.default_rng(1234)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    s = Settings(quantization=16, tiles_dimension=32)
    ref = ref_tiles(img, ref_checked(_ref_settings(s)))
    for n in (8, 3, 1):
        got = ptiles.encode_tiles_sharded(img, port_encode.checked_settings(s), _mesh(n, "tiles"))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))


# (image shape, settings, AKO_TPU_MANBAVARAN): the regular and ragged
# grids, 4 channels, raw blocks and the rANS extension
ENCODE = [
    ((96, 128, 3), Settings(quantization=16, tiles_dimension=32), None),
    ((80, 72, 4), Settings(quantization=16, tiles_dimension=32), None),
    ((48, 40, 3), Settings(quantization=0, gate=0, tiles_dimension=16), None),
    ((40, 48, 3), Settings(wavelet=Wavelet.NONE, tiles_dimension=16,
                           compression=ako_tpu_torch.Compression.NONE), None),
    ((64, 48, 3), Settings(quantization=16, tiles_dimension=32,
                           compression=ako_tpu_torch.Compression.MANBAVARAN), "1"),
]


@pytest.mark.parametrize("case", ENCODE, ids=["regular", "ragged4", "lossless", "raw", "manba"])
def test_encode_image_sharded(case, monkeypatch):
    """Blobs byte-equal to ako_tpu.encode's (its host entropy path on the
    CPU) and the port's one-device encode, over 8 shards, 3 and 1."""
    shape, s, manba = case
    if manba:
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", manba)
    rng = np.random.default_rng(sum(shape))
    img = (rng.integers(0, 256, size=shape) // 4 * 4).astype(np.uint8)
    ref = ako_tpu.encode(img, _ref_settings(s), device_entropy=False)
    assert ako_tpu_torch.encode(img, s, device="cpu") == ref
    for n in (8, 3, 1):
        assert ptiles.encode_image_sharded(img, s, _mesh(n, "tiles")) == ref


@pytest.mark.parametrize("device_entropy", [False, True])
@pytest.mark.parametrize("shape", [(96, 128, 3), (80, 72, 4)], ids=["regular", "ragged4"])
def test_decode_image_sharded(shape, device_entropy):
    """Pixels bit-equal to ako_tpu.decode's, on both entropy routes, over
    8 shards, 3 and 1; the ragged 4-channel grid pads each shape group's
    batch (pad rows repeat the last real tile)."""
    rng = np.random.default_rng(1234)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    blob = ako_tpu.encode(img, ako_tpu.Settings(quantization=16, tiles_dimension=32),
                          device_entropy=False)
    ref, _, _ = ako_tpu.decode(blob, device_entropy=False)
    for n in (8, 3, 1):
        got, s2, ch = ptiles.decode_image_sharded(blob, _mesh(n, "tiles"),
                                                  device_entropy=device_entropy)
        assert ch == shape[2] and s2.tiles_dimension == 32
        np.testing.assert_array_equal(got, ref)


def test_decode_quirk_tiles_ride_the_sharded_unlift(monkeypatch):
    """Tiles whose sync scan reports codes over 31 bits (the zigzag(-32768)
    quirk, forced as tests/test_parallel.py:273 forces it) decode on the
    host and then through decode_tiles_sharded; counted as fallbacks."""
    rng = np.random.default_rng(1234)
    img = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    blob = ako_tpu.encode(img, ako_tpu.Settings(quantization=16, tiles_dimension=32),
                          device_entropy=False)
    ref, _, _ = ako_tpu.decode(blob, device_entropy=False)
    real_sync = port_decode.kagari_sync_tiles
    hits = [0]

    def oversized_first(*a, **k):
        res = real_sync(*a, **k)
        hits[0] += 1
        return [res[0][:5] + (32,)] + res[1:]

    # the batched scan of decode.scan_blocks, which the sharded route calls
    monkeypatch.setattr(port_decode, "kagari_sync_tiles", oversized_first)
    metrics.reset()
    got, _, _ = ptiles.decode_image_sharded(blob, _mesh(8, "tiles"), device_entropy=True)
    assert hits[0] == 1
    np.testing.assert_array_equal(got, ref)
    c = metrics.fallback_summary()
    assert (c[metrics.DEC_HOST_FALLBACK], c[metrics.DEC_DEVICE]) == (1, 3)


def test_device_entropy_default_follows_the_mesh(monkeypatch):
    """device_entropy=None is the host route on a CPU mesh (the port's form
    of ako_tpu's backend test)."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8)
    blob = ako_tpu_torch.encode(img, Settings(quantization=16, tiles_dimension=16), device="cpu")
    calls = []
    monkeypatch.setattr(port_decode, "kagari_sync_tiles", lambda *a, **k: calls.append(a))
    got, _, _ = ptiles.decode_image_sharded(blob, _mesh(2, "tiles"))
    assert not calls
    np.testing.assert_array_equal(got, ako_tpu_torch.decode(blob, device="cpu")[0])

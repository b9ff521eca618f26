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


def test_no_shard_aliases_another(monkeypatch):
    """Every window, LL and output rows tensor of the sharded path has its
    own storage, distinct from every other shard's and from the input,
    though every shard is on one device."""
    seen = []
    lift, unlift = lk.lift_level_rows, lk.unlift_level_rows

    def ptr(t):
        return t.untyped_storage().data_ptr()

    def spy_lift(win, *a, **k):
        ll, rows = lift(win, *a, **k)
        seen.append(("fwd", a[2], [ptr(win), ptr(ll), ptr(rows)]))
        return ll, rows

    def spy_unlift(ll, chunk, *a, **k):
        out = unlift(ll, chunk, *a, **k)
        seen.append(("inv", a[2], [ptr(ll), ptr(chunk), ptr(out)]))
        return out

    monkeypatch.setattr(lk, "lift_level_rows", spy_lift)
    monkeypatch.setattr(lk, "unlift_level_rows", spy_unlift)
    rng = np.random.default_rng(11)
    planes = torch.from_numpy(rng.integers(-512, 512, size=(2, 100, 96)).astype(np.int16))
    schedule = geometry.lift_schedule(96, 100)
    qg = level_qg(ref_geometry.lift_schedule(96, 100), 2, 16, 0, 1)
    coeffs = forward_tile_sharded(planes, schedule, Wavelet.DD137, Wrap.REPEAT, qg, _mesh(8))
    inverse_tile_sharded(coeffs, schedule, Wavelet.DD137, Wrap.REPEAT, 2, _mesh(8))
    assert {kind for kind, _, _ in seen} == {"fwd", "inv"}
    for kind, k, _ in seen:
        ptrs = [p for kd, kk, ps in seen if (kd, kk) == (kind, k) for p in ps]
        assert len(set(ptrs)) == len(ptrs), f"{kind} level {k}: shards share storage"
        assert ptr(planes) not in ptrs and ptr(coeffs) not in ptrs


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
    (tests/test_parallel.py:173-193), over 8 shards and over 3."""
    from ako_tpu.encode import checked_settings as ref_checked
    from ako_tpu.encode import encode_tiles_device as ref_tiles

    rng = np.random.default_rng(1234)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    s = Settings(quantization=16, tiles_dimension=32)
    ref = ref_tiles(img, ref_checked(_ref_settings(s)))
    for n in (8, 3):
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
    CPU) and the port's one-device encode, over 8 shards and over 3."""
    shape, s, manba = case
    if manba:
        monkeypatch.setenv("AKO_TPU_MANBAVARAN", manba)
    rng = np.random.default_rng(sum(shape))
    img = (rng.integers(0, 256, size=shape) // 4 * 4).astype(np.uint8)
    ref = ako_tpu.encode(img, _ref_settings(s), device_entropy=False)
    assert ako_tpu_torch.encode(img, s, device="cpu") == ref
    for n in (8, 3):
        assert ptiles.encode_image_sharded(img, s, _mesh(n, "tiles")) == ref


@pytest.mark.parametrize("device_entropy", [False, True])
@pytest.mark.parametrize("shape", [(96, 128, 3), (80, 72, 4)], ids=["regular", "ragged4"])
def test_decode_image_sharded(shape, device_entropy):
    """Pixels bit-equal to ako_tpu.decode's, on both entropy routes; the
    ragged 4-channel grid pads each shape group's batch (pad rows repeat
    the last real tile)."""
    rng = np.random.default_rng(1234)
    img = rng.integers(0, 256, size=shape, dtype=np.uint8)
    blob = ako_tpu.encode(img, ako_tpu.Settings(quantization=16, tiles_dimension=32),
                          device_entropy=False)
    ref, _, _ = ako_tpu.decode(blob, device_entropy=False)
    for n in (8, 3):
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
    real_sync = ptiles.kagari_sync
    hits = [0]

    def oversized_first(*a, **k):
        res = real_sync(*a, **k)
        if res is not None and hits[0] == 0:
            hits[0] += 1
            return res[:5] + (32,)
        return res

    monkeypatch.setattr(ptiles, "kagari_sync", oversized_first)
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
    monkeypatch.setattr(ptiles, "kagari_sync", lambda *a, **k: calls.append(a))
    got, _, _ = ptiles.decode_image_sharded(blob, _mesh(2, "tiles"))
    assert not calls
    np.testing.assert_array_equal(got, ako_tpu_torch.decode(blob, device="cpu")[0])

"""ako_tpu_torch's split lift wiring (a level's V-only lifts: the H pass
along the last axis, then both halves' V passes, the plain versions of
K1v/K2v) against ako_tpu's: the Pallas kernels in AKO_TPU_PALLAS_MODE=split (interpret
mode) on even dims, and the XLA lift on odd heights and widths, which
the Pallas path hands to XLA and the port's kernels take themselves.
Inputs come from numpy seeds; every comparison is exact equality."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ako_tpu.core import geometry as ref_geometry
from ako_tpu.ops import pallas_lift as ref_pallas
from ako_tpu.ops import wavelets as ref_wavelets
from ako_tpu_torch.core import geometry
from ako_tpu_torch.core.settings import Wavelet, Wrap
from ako_tpu_torch.ops import lift_kernels, lifting, quantization, wavelets

WAVELETS = [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR]
PAIRS = list(itertools.product(WAVELETS, list(Wrap)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(rng, shape):
    return rng.integers(-32768, 32768, size=shape).astype(np.int16)


def _level(h, w):
    return geometry.lift_schedule(w, h).levels[0], ref_geometry.lift_schedule(w, h).levels[0]


@pytest.mark.parametrize("wavelet,wrap", PAIRS, ids=lambda v: v.name)
def test_split_level_vs_pallas_split(monkeypatch, wavelet, wrap):
    """Even dims: the wiring of pallas_lift.py:167-172 and :242-247,
    with the Pallas V-only kernels in interpret mode."""
    monkeypatch.setenv("AKO_TPU_PALLAS_MODE", "split")
    monkeypatch.setenv("AKO_TORCH_LIFT_MODE", "split")
    rng = np.random.default_rng(500 + 4 * int(wavelet) + int(wrap))
    lvl, _ = _level(16, 20)
    x = _rand(rng, (3, 16, 20))
    before = dict(lift_kernels.LAUNCHES)
    got = lift_kernels.lift2d_level(wavelet, wrap, _t(x), lvl)
    ref = ref_pallas.lift2d_pallas(wavelet, wrap, jnp.asarray(x))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    quads = [_rand(rng, (3, 8, 10)) for _ in range(4)]
    got = lift_kernels.unlift2d_level(wavelet, wrap, *map(_t, quads), lvl)
    ref = ref_pallas.unlift2d_pallas(wavelet, wrap, *map(jnp.asarray, quads))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # CPU tensors take the plain versions: no kernel launch counted
    assert lift_kernels.LAUNCHES == before


@pytest.mark.parametrize("wavelet,wrap", PAIRS, ids=lambda v: v.name)
@pytest.mark.parametrize("hw", [(17, 19), (9, 20), (16, 5)])
def test_split_level_vs_xla_odd(wavelet, wrap, hw):
    h, w = hw
    rng = np.random.default_rng(600 + 4 * int(wavelet) + int(wrap) + h)
    lvl, ref_lvl = _level(h, w)
    weff = wavelets.effective_wavelet(wavelet, lvl.target_w, lvl.target_h)
    x = _rand(rng, (2, h, w))
    got = lift_kernels.lift2d_level(weff, wrap, _t(x), lvl, mode="split")
    ref = ref_wavelets.lift2d(weff, wrap, jnp.asarray(x), ref_lvl)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    quads = [_rand(rng, (2, lvl.target_h, lvl.target_w)) for _ in range(4)]
    got = lift_kernels.unlift2d_level(weff, wrap, *map(_t, quads), lvl, mode="split")
    ref = ref_wavelets.unlift2d(weff, wrap, *map(jnp.asarray, quads), ref_lvl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("wavelet,wrap", PAIRS, ids=lambda v: v.name)
@pytest.mark.parametrize("h", [5, 12, 17])
def test_vlift_vunlift_vs_reference(wavelet, wrap, h):
    """V-only levels on odd and even heights: ako_tpu's lift1d along
    the rows (fake last row on odd h) and unlift1d_pair + interleave."""
    rng = np.random.default_rng(700 + 4 * int(wavelet) + int(wrap) + h)
    x = _rand(rng, (2, h, 7))
    lp, hp = wavelets.vlift(wavelet, wrap, _t(x))
    ref = ref_wavelets.lift1d(wavelet, wrap, jnp.asarray(x), h % 2, axis=-2)
    np.testing.assert_array_equal(lp.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(hp.numpy(), np.asarray(ref[1]))

    th = (h + 1) // 2
    lp, hp = _rand(rng, (2, th, 7)), _rand(rng, (2, th, 7))
    got = wavelets.vunlift(wavelet, wrap, _t(lp), _t(hp), h)
    ev, od = ref_wavelets.unlift1d_pair(wavelet, wrap, jnp.asarray(lp), jnp.asarray(hp), axis=-2)
    if h % 2:
        od = od[:, :-1]
    ref = ref_wavelets._interleave(ev, od, axis=-2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the wrappers take the plain versions on the CPU
    np.testing.assert_array_equal(
        lift_kernels.vunlift_level(wavelet, wrap, _t(lp), _t(hp), h).numpy(), got.numpy()
    )


@pytest.mark.parametrize("w,h", [(37, 45), (32, 32), (23, 9)])
def test_tile_split_equals_fused(monkeypatch, w, h):
    """forward_tile / inverse_tile give the same stream and planes in
    both wirings, with the wiring read from AKO_TORCH_LIFT_MODE."""
    ch = 3
    rng = np.random.default_rng(800 + w + h)
    planes = _t(rng.integers(-512, 512, size=(2, ch, h, w)).astype(np.int16))
    schedule = geometry.lift_schedule(w, h)
    qg = quantization.level_qg(schedule, ch, 16, 2, 1)
    out = {}
    for mode in lift_kernels.MODES:
        monkeypatch.setenv("AKO_TORCH_LIFT_MODE", mode)
        stream = lifting.forward_tile(planes, schedule, Wavelet.DD137, Wrap.CLAMP, qg)
        back = lifting.inverse_tile(stream, schedule, Wavelet.DD137, Wrap.CLAMP, ch)
        out[mode] = (stream.numpy(), back.numpy())
    for a, b in zip(out["fused"], out["split"]):
        np.testing.assert_array_equal(a, b)


def test_unknown_mode_raises(monkeypatch):
    lvl, _ = _level(8, 8)
    x = torch.zeros((1, 8, 8), dtype=torch.int16)
    monkeypatch.setenv("AKO_TORCH_LIFT_MODE", "fast")
    with pytest.raises(ValueError, match="unknown lift mode"):
        lift_kernels.lift2d_level(Wavelet.CDF53, Wrap.CLAMP, x, lvl)
    with pytest.raises(ValueError, match="unknown lift mode"):
        lift_kernels.lift_mode("both")


def test_vlift_rejects_devices_without_kernel():
    x = torch.zeros((1, 8, 8), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lift_kernels.vlift_level(Wavelet.CDF53, Wrap.CLAMP, x)
    q = torch.zeros((1, 4, 8), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lift_kernels.vunlift_level(Wavelet.CDF53, Wrap.CLAMP, q, q, 8)

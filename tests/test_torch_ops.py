"""ako_tpu_torch ops against ako_tpu's: integer helpers, colour
transforms, and one lift level each way (the plain versions of the
CUDA kernels) against the Pallas kernels in interpret mode and the XLA
lift. Inputs come from numpy seeds; every comparison is exact equality
(the codec is all-integer, so any difference is a fault)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ako_tpu.core import geometry as ref_geometry
from ako_tpu.core.settings import Color as RefColor
from ako_tpu.ops import colorspace as ref_colorspace
from ako_tpu.ops import intmath as ref_intmath
from ako_tpu.ops import pallas_lift as ref_pallas
from ako_tpu.ops import wavelets as ref_wavelets
from ako_tpu_torch.core import geometry
from ako_tpu_torch.core.settings import Color, Wavelet, Wrap
from ako_tpu_torch.ops import colorspace, intmath, lift_kernels, wavelets

WAVELETS = [Wavelet.DD137, Wavelet.CDF53, Wavelet.HAAR]
WRAPS = [Wrap.CLAMP, Wrap.MIRROR, Wrap.REPEAT, Wrap.ZERO]
EDGES = np.array(
    [-(2**31), -(2**31) + 1, -65536, -32769, -32768, -32767, -33, -32, -31, -17,
     -16, -15, -5, -4, -3, -2, -1, 0, 1, 2, 3, 4, 5, 15, 16, 17, 31, 32, 33,
     32767, 32768, 65535, 2**31 - 1],
    dtype=np.int32,
)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["div2", "div4", "div16", "div32", "i16"])
def test_intmath_edges(name):
    got = getattr(intmath, name)(_t(EDGES)).numpy()
    ref = np.asarray(getattr(ref_intmath, name)(jnp.asarray(EDGES)))
    np.testing.assert_array_equal(got, ref)


def test_divt_truncates():
    x = np.repeat(EDGES[2:-1], 5)
    d = np.tile(np.array([1, 2, 3, 7, 255], dtype=np.int32), EDGES.size - 3)
    got = intmath.divt(_t(x), _t(d)).numpy()
    ref = np.asarray(ref_intmath.divt(jnp.asarray(x), jnp.asarray(d)))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("color", list(Color))
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
@pytest.mark.parametrize("discard", [False, True])
def test_to_planar_yuv(color, ch, discard):
    rng = np.random.default_rng(100 + 10 * int(color) + ch)
    img = rng.integers(0, 256, size=(2, 7, 9, ch), dtype=np.uint8)
    img[:, :3, :, -1] = 0  # invisible pixels for discard-non-visible
    got = colorspace.to_planar_yuv(_t(img), color, discard).numpy()
    ref = np.asarray(ref_colorspace.to_planar_yuv(jnp.asarray(img), RefColor(color), discard))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("color", list(Color))
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_to_interleaved_u8(color, ch):
    rng = np.random.default_rng(200 + 10 * int(color) + ch)
    # wide range: saturation and the int16 wraps must match exactly
    planes = rng.integers(-32768, 32768, size=(2, ch, 7, 9)).astype(np.int16)
    got = colorspace.to_interleaved_u8(_t(planes), color, ch).numpy()
    ref = np.asarray(ref_colorspace.to_interleaved_u8(jnp.asarray(planes), RefColor(color), ch))
    np.testing.assert_array_equal(got, ref)


def _level(h, w):
    return geometry.lift_schedule(w, h).levels[0], ref_geometry.lift_schedule(w, h).levels[0]


def _quads(rng, n, lvl):
    return [
        rng.integers(-32768, 32768, size=(n, lvl.target_h, lvl.target_w)).astype(np.int16)
        for _ in range(4)
    ]


@pytest.mark.parametrize(
    "wavelet,wrap", list(itertools.product(WAVELETS, WRAPS)), ids=lambda v: v.name
)
def test_lift_level_vs_pallas_even(wavelet, wrap):
    """Even dims: the level the Pallas kernels K1/K2 compute."""
    rng = np.random.default_rng(300 + 4 * int(wavelet) + int(wrap))
    lvl, _ = _level(16, 20)
    x = rng.integers(-32768, 32768, size=(3, 16, 20)).astype(np.int16)
    got = lift_kernels.lift2d_level(wavelet, wrap, _t(x), lvl)
    ref = ref_pallas.lift2d_pallas(wavelet, wrap, jnp.asarray(x))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    quads = _quads(rng, 3, lvl)
    got = lift_kernels.unlift2d_level(wavelet, wrap, *map(_t, quads), lvl)
    ll, b, c, d = map(jnp.asarray, quads)
    ref = ref_pallas.unlift2d_pallas(wavelet, wrap, ll, b, c, d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "wavelet,wrap", list(itertools.product(WAVELETS, WRAPS)), ids=lambda v: v.name
)
@pytest.mark.parametrize("hw", [(17, 19), (9, 20), (16, 5)])
def test_lift_level_vs_xla_odd(wavelet, wrap, hw):
    """Odd dims (fake last row and/or column), which the Pallas path
    hands to XLA and the port's kernels take themselves."""
    h, w = hw
    rng = np.random.default_rng(400 + 4 * int(wavelet) + int(wrap) + h)
    lvl, ref_lvl = _level(h, w)
    x = rng.integers(-32768, 32768, size=(2, h, w)).astype(np.int16)
    got = lift_kernels.lift2d_level(wavelet, wrap, _t(x), lvl)
    ref = ref_wavelets.lift2d(wavelet, wrap, jnp.asarray(x), ref_lvl)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    quads = _quads(rng, 2, lvl)
    got = lift_kernels.unlift2d_level(wavelet, wrap, *map(_t, quads), lvl)
    ref = ref_wavelets.unlift2d(wavelet, wrap, *map(jnp.asarray, quads), ref_lvl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_lift_level_rejects_devices_without_kernel():
    lvl, _ = _level(8, 8)
    x = torch.zeros((1, 8, 8), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lift_kernels.lift2d_level(Wavelet.CDF53, Wrap.CLAMP, x, lvl)
    q = torch.zeros((1, 4, 4), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        lift_kernels.unlift2d_level(Wavelet.CDF53, Wrap.CLAMP, q, q, q, q, lvl)


def test_cpu_tensors_take_the_plain_version():
    before = dict(lift_kernels.LAUNCHES)
    lvl, _ = _level(8, 8)
    ll, b, c, d = lift_kernels.lift2d_level(
        Wavelet.CDF53, Wrap.CLAMP, torch.zeros((1, 8, 8), dtype=torch.int16), lvl
    )
    lift_kernels.unlift2d_level(Wavelet.CDF53, Wrap.CLAMP, ll, b, c, d, lvl)
    assert lift_kernels.LAUNCHES == before


@pytest.mark.parametrize("w,h", [(8, 8), (7, 9), (8, 100), (3, 3)])
def test_effective_wavelet(w, h):
    for wavelet in list(Wavelet):
        assert int(wavelets.effective_wavelet(wavelet, w, h)) == int(
            ref_wavelets.effective_wavelet(wavelet, w, h)
        )

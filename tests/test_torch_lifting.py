"""ako_tpu_torch's whole-tile lift pipeline against ako_tpu's:
forward_tile / inverse_tile (through the Pallas kernels in interpret
mode and through the XLA lift) and the per-level q/g tables. Exact
equality throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ako_tpu.core import geometry as ref_geometry
from ako_tpu.ops import lifting as ref_lifting
from ako_tpu.ops import quantization as ref_quantization
from ako_tpu_torch.core import geometry
from ako_tpu_torch.core.settings import Wavelet, Wrap
from ako_tpu_torch.ops import lifting, quantization


@pytest.mark.parametrize(
    "w,h,ch,q,g,chroma",
    [(32, 32, 3, 16, 0, 1), (97, 33, 4, 40, 3, 2), (9, 17, 1, 0, 0, 1), (128, 128, 3, 100, 8, 0)],
)
def test_level_qg(w, h, ch, q, g, chroma):
    got = quantization.level_qg(geometry.lift_schedule(w, h), ch, q, g, chroma)
    ref = ref_quantization.level_qg(ref_geometry.lift_schedule(w, h), ch, q, g, chroma)
    assert got == ref


# (w, h, use_pallas): power-of-two (every level through the Pallas
# kernels), odd dims (fake row/col, which Pallas hands to XLA), and
# shapes whose small levels drop DD137 to CDF53 (< 8 on a side)
SHAPES = [(32, 32, True), (32, 32, False), (64, 12, True), (48, 33, False), (23, 17, False)]
CASES = [
    (Wavelet.DD137, Wrap.CLAMP, 16),
    (Wavelet.DD137, Wrap.MIRROR, 0),
    (Wavelet.CDF53, Wrap.REPEAT, 30),
    (Wavelet.HAAR, Wrap.ZERO, 16),
]


def _qg(w, h, ch, q):
    return quantization.level_qg(geometry.lift_schedule(w, h), ch, q, 2, 1)


@pytest.mark.parametrize("w,h,use_pallas", SHAPES)
@pytest.mark.parametrize(
    "wavelet,wrap,q", CASES, ids=[f"{a.name}-{b.name}-q{q}" for a, b, q in CASES]
)
def test_forward_inverse_tile(w, h, use_pallas, wavelet, wrap, q):
    ch = 3
    rng = np.random.default_rng(w * 1000 + h + q)
    planes = rng.integers(-512, 512, size=(2, ch, h, w)).astype(np.int16)
    qg = _qg(w, h, ch, q)

    ref_sched = ref_geometry.lift_schedule(w, h)
    ref = np.asarray(
        jax.jit(
            lambda p: ref_lifting.forward_tile(p, ref_sched, wavelet, wrap, qg, use_pallas)
        )(jnp.asarray(planes))
    )
    got = lifting.forward_tile(
        torch.from_numpy(planes), geometry.lift_schedule(w, h), wavelet, wrap, qg
    ).numpy()
    np.testing.assert_array_equal(got, ref)

    ref_back = np.asarray(
        jax.jit(
            lambda c: ref_lifting.inverse_tile(c, ref_sched, wavelet, wrap, ch, use_pallas)
        )(jnp.asarray(ref))
    )
    back = lifting.inverse_tile(
        torch.from_numpy(got), geometry.lift_schedule(w, h), wavelet, wrap, ch
    ).numpy()
    np.testing.assert_array_equal(back, ref_back)
    if q == 0:
        np.testing.assert_array_equal(back, planes)


def test_inverse_tile_wraps_dequantize():
    """q > 1 heads multiply with an int16 wrap; q <= 1 leaves values."""
    w, h, ch = 16, 16, 2
    sched = geometry.lift_schedule(w, h)
    n = sched.coeff_count(ch)
    rng = np.random.default_rng(7)
    coeffs = rng.integers(-32768, 32768, size=(1, n)).astype(np.int16)
    ref_sched = ref_geometry.lift_schedule(w, h)
    ref = np.asarray(
        jax.jit(
            lambda c: ref_lifting.inverse_tile(c, ref_sched, Wavelet.DD137, Wrap.CLAMP, ch)
        )(jnp.asarray(coeffs))
    )
    got = lifting.inverse_tile(
        torch.from_numpy(coeffs), sched, Wavelet.DD137, Wrap.CLAMP, ch
    ).numpy()
    np.testing.assert_array_equal(got, ref)

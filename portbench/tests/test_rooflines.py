"""The roofline yardstick's counts from shapes."""

import pytest

from ako_tpu_torch.core import geometry
from portbench.harness import rooflines as R
from portbench.tests.conftest import load_config


def test_peaks_are_constants():
    assert R.INT32_OPS_PER_S == pytest.approx(1.672704e13)
    assert R.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("w,h,c", [(128, 128, 4), (1632, 2464, 3), (200, 136, 4), (5, 3, 1)])
def test_stream_values_are_the_wire_format(w, h, c):
    assert R.stream_values(w, h, c) == geometry.lift_schedule(w, h).coeff_count(c)


def test_tiles_of_the_configs():
    cafe, tractor = load_config("cafe_t128"), load_config("tractor_whole")
    assert R.tile_shapes(cafe) == [(128, 128)] * 80
    assert R.tile_shapes(tractor) == [(1632, 2464)]
    assert R.stream_values(128, 128, 4) == 65560


def test_lift_counts():
    """A 16x16 plane: levels 8x8 (DD 13/7), 4x4 and 2x2 (CDF 5/3)."""
    ops = 8 * (64 * 9 + 16 * 6 + 4 * 6)
    cfg = {"width": 16, "height": 16, "channels": 1,
           "settings": {"tiles_dimension": 0, "wavelet": "DD137"}}
    nbytes = 256 + 2 * R.stream_values(16, 16, 1)
    assert R.lift(cfg) == pytest.approx(max(nbytes / 3.35e12, ops / R.INT32_OPS_PER_S) * 1e3)
    assert R.unlift(cfg) == R.lift(cfg)


def test_kagari_and_rate_bounds():
    cafe = load_config("cafe_t128")
    values = 80 * 65560
    # operations bound every one of them on the cafe's shapes
    assert R.kagari_encode(cafe, 10**6) == pytest.approx(values * 30 / R.INT32_OPS_PER_S * 1e3)
    assert R.kagari_decode(cafe, 10**6) == pytest.approx(values * 20 / R.INT32_OPS_PER_S * 1e3)
    assert R.rate_sizes(cafe) == pytest.approx(values * 23 / R.INT32_OPS_PER_S * 1e3)
    # bytes: a payload as large as the streams tips K4 over
    assert R.kagari_decode(cafe, 10**9) == pytest.approx((10**9 + 2 * values) / 3.35e12 * 1e3)

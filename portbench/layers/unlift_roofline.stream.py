"""ops/lift_kernels.py's inverse lift in the stream (unlift_pyramid, and
unlift_level on large planes): the least time of one image's inverse
times the images whose inverse is in the trace (its unlift_pyramid
launches over the image's tile shapes), over those kernels' device
time, in percent."""

from portbench.harness import rooflines


def read(window):
    device_ms = window.kernel_us("unlift_pyramid", "unlift_level") / 1e3
    images = window.kernels("unlift_pyramid") / len(set(rooflines.tile_shapes(window.config)))
    return 100.0 * images * rooflines.unlift(window.config) / device_ms if device_ms else None

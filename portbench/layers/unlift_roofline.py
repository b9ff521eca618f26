"""ops/lift_kernels.py's inverse lift (unlift_pyramid, unlift_level): the
window's decodes' least time over the device time of those kernels, in
percent."""

from portbench.harness import rooflines


def read(window):
    device_ms = window.kernel_us("unlift_pyramid", "unlift_level") / 1e3
    n = len(window.requests_of("decode"))
    return 100.0 * n * rooflines.unlift(window.config) / device_ms if n and device_ms else None

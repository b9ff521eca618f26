"""ops/lift_kernels.py's forward lift (lift_pyramid, lift_level): the
window's encodes' least time (portbench/harness/rooflines.py) over the
device time of those kernels in the trace, in percent."""

from portbench.harness import rooflines


def read(window):
    device_ms = window.kernel_us("lift_pyramid", "lift_level") / 1e3
    n = len(window.requests_of("encode"))
    return 100.0 * n * rooflines.lift(window.config) / device_ms if n and device_ms else None

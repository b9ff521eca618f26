"""ops/rate_device.py's probe sizes (K8p, rate_sizes): a probe's least
time times the probes in the trace (its rate_sizes launches over the
image's tile shapes) over the kernel's device time, in percent."""

from portbench.harness import rooflines


def read(window):
    device_ms = window.kernel_us("rate_sizes") / 1e3
    probes = window.kernels("rate_sizes") / len(set(rooflines.tile_shapes(window.config)))
    return 100.0 * probes * rooflines.rate_sizes(window.config) / device_ms if device_ms else None

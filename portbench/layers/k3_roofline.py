"""ops/kagari_device.py's Kagari encode (K3, kagari_encode): the window's
encodes' least time, each with the payload bytes its blob carries, over
the kernel's device time, in percent."""

from portbench.harness import rooflines


def read(window):
    device_ms = window.kernel_us("kagari_encode") / 1e3
    bound = sum(rooflines.kagari_encode(window.config, r.payload_bytes)
                for r in window.requests_of("encode"))
    return 100.0 * bound / device_ms if bound and device_ms else None

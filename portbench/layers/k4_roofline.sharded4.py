"""ops/kagari_device.py's Kagari decode (K4, kagari_decode) in the
tile-sharded decode: the window's decodes' least time on one card, each
with its blob's payload bytes, over the kernel's device time summed over
the four cards' launches (a shard's pad tiles included), in percent."""

from portbench.harness import rooflines


def read(window):
    device_ms = window.kernel_us("kagari_decode") / 1e3
    bound = sum(rooflines.kagari_decode(window.config, r.payload_bytes)
                for r in window.requests_of("decode"))
    return 100.0 * bound / device_ms if bound and device_ms else None

"""ops/kagari_device.py's Kagari decode (K4, kagari_decode) in the stream:
the least time of the kernel's launches in the trace, each at the mean
payload of the images the window completed, over the kernel's device
time, in percent. Counting launches, not images, keeps the images in
flight at the window's edges out of the count."""

from portbench.harness import rooflines


def read(window):
    images = window.requests_of("image")
    device_ms = window.kernel_us("kagari_decode") / 1e3
    if not images or not device_ms:
        return None
    per_image = sum(rooflines.kagari_decode(window.config, r.payload_bytes)
                    for r in images) / len(images)
    launches = window.kernels("kagari_decode") / len(set(rooflines.tile_shapes(window.config)))
    return 100.0 * launches * per_image / device_ms

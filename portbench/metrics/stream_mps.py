"""Megapixels whose round trip completed in the window, over the
window's seconds."""


def read(result, mix, config):
    if not result.images_done:
        return None
    return result.images_done * config["width"] * config["height"] / 1e6 / result.seconds

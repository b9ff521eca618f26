"""95th percentile of the host-clock ms of all the window's decodes
(numpy's linear interpolation)."""

import numpy as np


def read(result, mix, config):
    ms = result.ms_of("decode")
    return float(np.percentile(ms, 95)) if ms else None

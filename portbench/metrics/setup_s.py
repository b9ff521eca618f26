"""Seconds from the process's start to the first timed request: imports,
CUDA, the kernels' library, the pool, the warm request."""


def read(result, mix, config):
    return result.setup_s

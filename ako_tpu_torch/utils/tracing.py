"""Profiler tracing, env-gated: the counterpart of
ako_tpu/utils/tracing.py.

The reference exposes per-stage wall-clock through the event callbacks
(library/ako.h:75-84, core/events.py). For device visibility set
`AKO_TPU_TRACE_DIR=/some/dir`: every top-level `ako_tpu_torch.encode` /
`ako_tpu_torch.decode` call then writes a torch.profiler trace there, a
Chrome trace (JSON) of its torch ops, copies and host activity, and its
kernels on the card when CUDA is present.

Without the env var the wrapper costs one dict lookup. Traces do not
nest: a call made while another is traced (another thread, or a nested
call) runs untraced.
"""

from __future__ import annotations

import functools
import itertools
import os
import threading

_ENV = "AKO_TPU_TRACE_DIR"
# one profiler session at a time in a process: a try-lock, so concurrent
# or nested calls run untraced instead of failing
_trace_lock = threading.Lock()
_serial = itertools.count()


def trace_path(trace_dir: str, name: str) -> str:
    """The file of one traced call: <dir>/<entry point>-<pid>-<serial>.json."""
    return os.path.join(trace_dir, f"{name}-{os.getpid()}-{next(_serial)}.json")


def traced(fn):
    """Wrap a top-level codec entry point in a torch.profiler trace when
    AKO_TPU_TRACE_DIR is set."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        trace_dir = os.environ.get(_ENV)
        if not trace_dir or not _trace_lock.acquire(blocking=False):
            return fn(*args, **kwargs)
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            with profile(activities=activities) as prof:
                result = fn(*args, **kwargs)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(trace_path(trace_dir, fn.__name__))
            return result
        finally:
            _trace_lock.release()

    return wrapper

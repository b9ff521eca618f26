"""Profiler tracing, env-gated: the counterpart of
ako_tpu/utils/tracing.py, and the program's own spans.

The reference exposes per-stage wall-clock through the event callbacks
(library/ako.h:75-84, core/events.py). For device visibility set
`AKO_TPU_TRACE_DIR=/some/dir`: every top-level `ako_tpu_torch.encode` /
`ako_tpu_torch.decode` call then writes a torch.profiler trace there, a
Chrome trace (JSON) of its torch ops, copies and host activity on every
thread, and its kernels on the card when CUDA is present.

Without the env var the wrapper costs one dict lookup. Traces do not
nest: a call made while another is traced (another thread, or a nested
call) runs untraced.

`span(name)` marks a stretch of the program's host work. While a
torch.profiler records it is a profiler range, on the same clock as the
card's kernels and copies, and it is also kept, with its thread, in a
log that `recorded_spans()` reads: a profiler started
without `profile_all_threads` records no range opened on another thread
(the scan pool, the executor's IO threads, the stream's encoder). With
no profiler it is one shared null context, and no range is built.
Native code that times its own threads' work logs it with `log_spans`:
log entries only, no profiler range.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import os
import threading
import time
from collections import deque

from torch._C import _profiler as _ranges
from torch.autograd import profiler as _profiler

_ENV = "AKO_TPU_TRACE_DIR"
# one profiler session at a time in a process: a try-lock, so concurrent
# or nested calls run untraced instead of failing
_trace_lock = threading.Lock()
_serial = itertools.count()

_NULL = contextlib.nullcontext()
#: the newest spans closed while a profiler recorded, as (name, native
#: thread id, start ns, end ns) on time.time_ns()'s clock, which is the
#: profiler's: process-wide, as the profiler is. A 51-s traced stream of
#: 1024x1280 images (about 1,100 of them, 88 spans each) closes 100,000.
_KEPT = 1 << 19
_log: deque = deque(maxlen=_KEPT)
_log_lock = threading.Lock()


class _Span:
    """One span while a profiler records: its range, and its log entry.
    The range is at function scope: a record_function range (user scope)
    also makes the profiler lay an annotation, typed as a device event,
    over the kernels launched inside it, which a reader of the device's
    events would count as the card's busy time."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = _ranges._RecordFunctionFast(name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._range.__exit__(*exc)
        with _log_lock:
            _log.append((self.name, threading.get_native_id(), self._t0, t1))
        return False


def span(name: str):
    """A context around a stretch of host work named `name` (`ako.*`):
    a profiler range and a log entry while a profiler records, else a
    shared null context (one flag read)."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def recording() -> bool:
    """Whether a profiler records, so that spans are built and logged."""
    return _profiler._is_profiler_enabled


def log_spans(name: str, tids, starts, ends) -> None:
    """Log spans that native code timed on its own threads, one a
    (native thread id, start ns, end ns) on time.time_ns()'s clock, as
    `span` logs its own. For callers that saw `recording()`."""
    with _log_lock:
        _log.extend(zip(itertools.repeat(name), tids, starts, ends))


def recorded_spans(since_ns: int = 0) -> list:
    """The logged spans that started at or after `since_ns`
    (time.time_ns()), oldest first: [(name, thread id, start ns, end ns)]."""
    with _log_lock:
        return [s for s in _log if s[2] >= since_ns]


def trace_path(trace_dir: str, name: str) -> str:
    """The file of one traced call: <dir>/<entry point>-<pid>-<serial>.json."""
    return os.path.join(trace_dir, f"{name}-{os.getpid()}-{next(_serial)}.json")


def traced(fn):
    """Wrap a top-level codec entry point in a torch.profiler trace of
    every thread when AKO_TPU_TRACE_DIR is set."""

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
            every_thread = _ranges._ExperimentalConfig(profile_all_threads=True)
            with profile(activities=activities, experimental_config=every_thread) as prof:
                result = fn(*args, **kwargs)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(trace_path(trace_dir, fn.__name__))
            return result
        finally:
            _trace_lock.release()

    return wrapper

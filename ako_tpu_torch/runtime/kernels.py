"""Build-and-load for the port's Hopper kernels: the per-level lift
kernels of the per-level API (csrc/lift2d.cu), the split wiring's V-only
lifts along either axis (csrc/vlift.cu), the whole-pyramid lift kernels
(csrc/lift_pyramid.cu), the one-launch level
kernels for planes too large for a pyramid block and their shard-table
instances for a device's shards of a row-sharded level (K7;
csrc/lift_level.cu), the
Kagari tokenize + pack (csrc/kagari_encode.cu, one launch a call), the
Kagari block decoder (csrc/kagari_decode.cu), the Manbavaran rANS
encoder and block decoder (csrc/manba_encode.cu, csrc/manba_decode.cu),
and the rate search's kernels: its serialization and its payload sizes
(csrc/rate.cu).

At first use one `nvcc -c` per source, all started together, then one
link build a shared library with a plain C interface in this package's
`_build/` directory, cached by the mtime of the sources and the header
they share; ctypes binds it. Device pointers and the CUDA stream are
passed as integers (c_void_p), the pyramid, level and rate kernels'
tables as a pointer to a PyramidArgs, LevelArgs (with K7's ShardArgs),
VliftArgs (with a VliftPtrs) or RateArgs that the C side passes to the
kernel by value. Nothing
here runs at import: the CPU tests import this module on machines with
no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

from ako_tpu_torch.runtime.build import BUILD_DIR

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = [
    os.path.join(_PKG, "csrc", f)
    for f in ("lift2d.cu", "vlift.cu", "lift_pyramid.cu", "lift_level.cu", "kagari_encode.cu",
              "kagari_decode.cu", "manba_encode.cu", "manba_decode.cu", "rate.cu")
]
#: what the library is rebuilt after: the sources and the headers they include
DEPENDS = [*SOURCES, *(os.path.join(_PKG, "csrc", h)
                       for h in ("lift_common.cuh", "rate_common.cuh"))]
_LIB = os.path.join(BUILD_DIR, "libako_kernels.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: table sizes of csrc/lift_pyramid.cu, and its largest cluster (the
#: inverse's channels of a tile)
MAX_LEVELS = 16
MAX_CHANNELS = 16
MAX_CLUSTER = 8
#: channels of csrc/lift_level.cu's table, and K7's shards and segments
#: a launch
MAX_LEVEL_CHANNELS = 16
MAX_SHARDS = 32
MAX_SEGS = 64
#: (level, channel) segments of csrc/rate_common.cuh's table
MAX_RATE_SEGS = 496


class PyramidArgs(ctypes.Structure):
    """csrc/lift_pyramid.cu PyramidArgs, field for field (all int)."""

    _fields_ = [
        *((name, ctypes.c_int) for name in (
            "levels", "channels", "height", "width", "rows", "pitch", "coeffs",
            "wrap", "color", "discard", "u8",
        )),
        ("wavelet", ctypes.c_int * MAX_LEVELS),
        ("off", ctypes.c_int * MAX_LEVELS),
        ("q", (ctypes.c_int * MAX_CHANNELS) * MAX_LEVELS),
        ("g", (ctypes.c_int * MAX_CHANNELS) * MAX_LEVELS),
    ]


class LevelArgs(ctypes.Structure):
    """csrc/lift_level.cu LevelArgs, field for field (all int)."""

    _fields_ = [
        *((name, ctypes.c_int) for name in (
            "channels", "height", "width", "rh", "rw", "wavelet", "wrap", "color", "discard",
            "u8", "coeffs", "off", "ll_stride",
        )),
        ("q", ctypes.c_int * MAX_LEVEL_CHANNELS),
        ("g", ctypes.c_int * MAX_LEVEL_CHANNELS),
        *((name, ctypes.c_int) for name in ("pitch", "plane", "stage", "smem")),
    ]


class Seg(ctypes.Structure):
    """csrc/lift_level.cu Seg: a run of rows [r0, r1) of a K7 launch's
    source, row r of channel ch (quadrant q) at base + ch chan + q quad +
    (r - r0) pitch int16 elements."""

    _fields_ = [("base", ctypes.c_void_p), ("chan", ctypes.c_longlong), ("quad", ctypes.c_longlong),
                ("r0", ctypes.c_int), ("r1", ctypes.c_int), ("pitch", ctypes.c_int)]


class ShardArgs(ctypes.Structure):
    """csrc/lift_level.cu ShardArgs, field for field (cta0 is the
    launcher's to fill)."""

    _fields_ = [
        ("shards", ctypes.c_int),
        ("p0", ctypes.c_int * MAX_SHARDS),
        ("p1", ctypes.c_int * MAX_SHARDS),
        ("cta0", ctypes.c_int * (MAX_SHARDS + 1)),
        *((name, ctypes.c_int) for name in ("segs", "lls", "out_p0", "out_len")),
        ("heads", ctypes.c_void_p),
        ("head_stride", ctypes.c_longlong),
        ("seg", Seg * MAX_SEGS),
    ]


class VliftArgs(ctypes.Structure):
    """csrc/vlift.cu VliftArgs, field for field (all int)."""

    _fields_ = [(name, ctypes.c_int) for name in ("n", "h", "w", "axis", "wavelet", "wrap", "groups")]


class VliftPtrs(ctypes.Structure):
    """csrc/vlift.cu VliftPtrs: a launch's device pointers."""

    _fields_ = [("in_", ctypes.c_void_p * 4), ("out", ctypes.c_void_p * 4)]


class RateArgs(ctypes.Structure):
    """csrc/rate_common.cuh RateArgs, field for field."""

    _fields_ = [
        *((name, ctypes.c_int) for name in ("n", "lp", "segs")),
        ("start", ctypes.c_int * MAX_RATE_SEGS),
        ("q", ctypes.c_int16 * MAX_RATE_SEGS),
        ("g", ctypes.c_int16 * MAX_RATE_SEGS),
    ]


_lock = threading.Lock()
_lib = None
#: guards the wrappers' LAUNCHES counters: the executor launches from two
#: threads at once (its dispatch thread, and roundtrip_iter's encoder)
_launch_lock = threading.Lock()


def count_launch(counts: dict, name: str) -> None:
    """One more launch of `name` in a wrapper's LAUNCHES counters."""
    with _launch_lock:
        counts[name] += 1

#: nvcc's output from this process's build (ptxas register and spill
#: counts); empty when the library came from the cache
build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

#: argtypes per exported symbol; every one returns a cudaError_t as int
_SIGNATURES = {
    "ako_lift2d": [_P] * 7 + [_LL, _I, _I, _I, _I, _P],
    "ako_unlift2d": [_P] * 7 + [_LL, _I, _I, _I, _I, _P],
    "ako_vlift": [ctypes.POINTER(VliftArgs), ctypes.POINTER(VliftPtrs), _P],
    "ako_vunlift": [ctypes.POINTER(VliftArgs), ctypes.POINTER(VliftPtrs), _P],
    "ako_kagari_encode": [_P] * 4 + [_LL, _I, _I, ctypes.c_uint, _I, _I, _I, _P],
    "ako_kagari_decode": [_P, _LL] + [_P] * 6 + [_I, _I, _I, _I, _P],
    "ako_lift_pyramid": [ctypes.POINTER(PyramidArgs), _P, _P, _I, _P],
    "ako_unlift_pyramid": [ctypes.POINTER(PyramidArgs), _P, _P, _I, _P],
    "ako_lift_level": [ctypes.POINTER(LevelArgs), _P, _P, _P, _I, _P],
    "ako_unlift_level": [ctypes.POINTER(LevelArgs), _P, _P, _P, _I, _P],
    "ako_lift_level_shards": [ctypes.POINTER(LevelArgs), ctypes.POINTER(ShardArgs), _P, _P, _P],
    "ako_unlift_level_shards": [ctypes.POINTER(LevelArgs), ctypes.POINTER(ShardArgs), _P, _P],
    "ako_manba_encode": [_P] * 5 + [_I, _I, _I, _I, _P],
    "ako_manba_decode": [_P, _LL] + [_P] * 8 + [_I, _I, _I, _P],
    "ako_rate_serialize": [_P, _P, _I, ctypes.POINTER(RateArgs), _P],
    "ako_rate_sizes": [_P, _P, _P, _LL, _I, _I, _I, ctypes.POINTER(RateArgs), _P],
    "ako_rate_sizes_ctas": [ctypes.POINTER(_I)],
    # measurements of K6e's chain, called through the library by
    # chip_smoke.py and chip_probe.py; the codec never calls them
    "ako_manba_encode_chains": [_P] * 5 + [_I, _I, _I, _I, _P],
    "ako_manba_chain_alone": [_P, _I, _P, _P, _P],
    "ako_manba_op_latency": [_P, _P, _I, _I, _P],
    # the launch floor, an empty kernel (chip_smoke.py, chip_probe.py)
    "ako_launch_floor": [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _compile() -> None:
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o") for src in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    for src, proc, out in zip(SOURCES, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{out}")
    tmp = f"{_LIB}.{tag}"
    res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
    for obj in objs:
        os.remove(obj)
    build_log = "".join(logs)
    os.replace(tmp, _LIB)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < max(map(os.path.getmtime, DEPENDS)):
            _compile()
        lib = ctypes.CDLL(_LIB)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = _I
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def lift2d(x, lp, hp, ll, b, c, d, n, cur_h, cur_w, wavelet, wrap, stream) -> None:
    """Launch the forward level on `stream`; arguments are device
    pointers (ints) and sizes, already checked by the caller."""
    _check(
        load().ako_lift2d(x, lp, hp, ll, b, c, d, n, cur_h, cur_w, wavelet, wrap, stream),
        "ako_lift2d",
    )


def unlift2d(ll, b, c, d, left, right, out, n, cur_h, cur_w, wavelet, wrap, stream) -> None:
    """Launch the inverse level on `stream` (see lift2d)."""
    _check(
        load().ako_unlift2d(ll, b, c, d, left, right, out, n, cur_h, cur_w, wavelet, wrap, stream),
        "ako_unlift2d",
    )


def _ptrs(ins, outs) -> VliftPtrs:
    p = VliftPtrs()
    p.in_[: len(ins)] = ins
    p.out[: len(outs)] = outs
    return p


def vlift(args, ins, outs, stream) -> None:
    """Launch the V-only forward lift (K1v) on `stream`: `args` a
    VliftArgs, `ins` its calls' input pointers, `outs` their (lp, hp)
    pointers in call order, already checked by the caller."""
    _check(load().ako_vlift(ctypes.byref(args), ctypes.byref(_ptrs(ins, outs)), stream),
           "ako_vlift")


def vunlift(args, ins, outs, stream) -> None:
    """Launch the V-only inverse lift (K2v) on `stream`: `ins` the calls'
    (lp, hp) pointers in call order, `outs` their planes' (see vlift)."""
    _check(load().ako_vunlift(ctypes.byref(args), ctypes.byref(_ptrs(ins, outs)), stream),
           "ako_vunlift")


def launch_floor(stream) -> None:
    """Launch the empty kernel on `stream` (a measurement; the codec never
    calls it)."""
    _check(load().ako_launch_floor(stream), "ako_launch_floor")


def kagari_encode(values, out, totals, scratch, scratch_words, rows_cap, chunks_cap, epoch, rows,
                  n, row_words, stream) -> None:
    """Launch the Kagari tokenize + pack (K3, one grid launch with
    decoupled look-back over the reused `scratch`, a new `epoch` each
    call) on `stream`."""
    _check(
        load().ako_kagari_encode(values, out, totals, scratch, scratch_words, rows_cap, chunks_cap,
                                 epoch, rows, n, row_words, stream),
        "ako_kagari_encode",
    )


def kagari_decode(pool, pool_words, base, bit_off, prev, consec, run, out, tiles, blocks,
                  n_outputs, block, stream) -> None:
    """Launch the Kagari block decoder (K4) on `stream`."""
    _check(
        load().ako_kagari_decode(pool, pool_words, base, bit_off, prev, consec, run, out,
                                 tiles, blocks, n_outputs, block, stream),
        "ako_kagari_decode",
    )


def lift_pyramid(args, src, out, tiles, stream) -> None:
    """Launch the forward pyramid (one block per tile and channel) on
    `stream`; `args` is a PyramidArgs, the rest device pointers and the
    tile count, already checked by the caller."""
    _check(load().ako_lift_pyramid(ctypes.byref(args), src, out, tiles, stream), "ako_lift_pyramid")


def unlift_pyramid(args, coeffs, dst, tiles, stream) -> None:
    """Launch the inverse pyramid (one block per tile) on `stream`."""
    _check(load().ako_unlift_pyramid(ctypes.byref(args), coeffs, dst, tiles, stream),
           "ako_unlift_pyramid")


def lift_level(args, src, out, ll, tiles, stream) -> None:
    """Launch one forward level (one CTA per tile and region) on `stream`;
    `args` is a LevelArgs, the rest device pointers and the tile count,
    already checked by the caller."""
    _check(load().ako_lift_level(ctypes.byref(args), src, out, ll, tiles, stream), "ako_lift_level")


def unlift_level(args, ll, coeffs, dst, tiles, stream) -> None:
    """Launch one inverse level on `stream` (see lift_level)."""
    _check(load().ako_unlift_level(ctypes.byref(args), ll, coeffs, dst, tiles, stream),
           "ako_unlift_level")


def lift_level_shards(args, shards, out, ll, stream) -> None:
    """Launch K7's forward, a device's shards of a level (one CTA per
    region of each shard's pairs), on `stream`; `args` is a LevelArgs,
    `shards` a ShardArgs with the shards and the segments, the rest device
    pointers, already checked by the caller."""
    _check(load().ako_lift_level_shards(ctypes.byref(args), ctypes.byref(shards), out, ll, stream),
           "ako_lift_level_shards")


def unlift_level_shards(args, shards, dst, stream) -> None:
    """Launch K7's inverse on `stream` (see lift_level_shards)."""
    _check(load().ako_unlift_level_shards(ctypes.byref(args), ctypes.byref(shards), dst, stream),
           "ako_unlift_level_shards")


def manba_encode(values, record, scratch, rans, extras, rows, n, budget, row_words, stream) -> None:
    """Launch the Manbavaran encoder (K6e, three launches: symbols and
    histograms, the model, the chains beside the extras pack) on
    `stream`."""
    _check(load().ako_manba_encode(values, record, scratch, rans, extras, rows, n, budget,
                                   row_words, stream), "ako_manba_encode")


def manba_decode(pool, pool_words, base, rans_end, extras_off, x, rbyte, ebit, freq, out, tiles,
                 blocks, n_outputs, stream) -> None:
    """Launch the Manbavaran block decoder (K6d) on `stream`."""
    _check(load().ako_manba_decode(pool, pool_words, base, rans_end, extras_off, x, rbyte, ebit,
                                   freq, out, tiles, blocks, n_outputs, stream),
           "ako_manba_decode")


def rate_serialize(raw, out, rows, args, stream) -> None:
    """Launch the rate search's serialization (K8s) on `stream`: `args` a
    RateArgs, the rest device pointers and the row count, already checked
    by the caller."""
    _check(load().ako_rate_serialize(raw, out, rows, ctypes.byref(args), stream),
           "ako_rate_serialize")


def rate_sizes(raw, sizes, scratch, scratch_words, rows_cap, spans_cap, rows, args,
               stream) -> None:
    """Launch the rate search's payload sizes (K8p, one launch over the
    reused `scratch`: span records and self-resetting row counters) on
    `stream`."""
    _check(load().ako_rate_sizes(raw, sizes, scratch, scratch_words, rows_cap, spans_cap, rows,
                                 ctypes.byref(args), stream), "ako_rate_sizes")


def rate_sizes_ctas() -> int:
    """K8p's grid on the current CUDA device: resident CTAs a SM times the
    SMs (the C side asks once a device)."""
    ctas = ctypes.c_int(0)
    _check(load().ako_rate_sizes_ctas(ctypes.byref(ctas)), "ako_rate_sizes_ctas")
    return ctas.value

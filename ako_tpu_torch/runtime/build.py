"""Build-and-load for the native host runtime (entropy coder, q/g curve).

The C source is the port's own copy, `csrc/akort.c` (the same code as
ako_tpu's `runtime/native/akort.c`; the port reads no file of the JAX
package). The library goes into this package's `_build/` directory,
cached by source mtime, and is bound with ctypes. No pip/apt
dependencies: plain cc + libm (and the C library's threads).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "akort.c")
BUILD_DIR = os.path.join(_PKG, "_build")
_LIB = os.path.join(BUILD_DIR, "_akort.so")

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SZ = ctypes.c_size_t

#: (restype, argtypes) per bound symbol — the same signatures as
#: ako_tpu/runtime/build.py binds, for the functions the port calls,
#: but for akort_kagari_sync's last pointer (the values it jumped) and
#: the port's own akort_kagari_sync_tiles
_SIGNATURES = {
    "akort_quantization": (_I32, [_I32, _I32] + [ctypes.c_uint64] * 4),
    "akort_gate": (_I32, [_I32, _I32] + [ctypes.c_uint64] * 4),
    "akort_kagari_encode": (_SZ, [_P, _SZ, _P, _SZ]),
    "akort_kagari_decode": (_SZ, [_SZ, _P, _SZ, _P, _SZ]),
    "akort_manba_encode": (_SZ, [_P, _SZ, _P, _SZ]),
    "akort_manba_decode": (_SZ, [_SZ, _P, _SZ, _P, _SZ]),
    "akort_kagari_sync": (_SZ, [_SZ, _P, _SZ, _SZ, _SZ, _P, _P, _P, _P, _P, _P]),
    # blob, n, pay_off, pay_size, counts, caps, rec_off, block, threads,
    # bit_off, prev, consec, run, consumed, max_bits, jumped, t_start,
    # t_end, tid
    "akort_kagari_sync_tiles": (_I32, [_P, _I64, _P, _P, _P, _P, _P, _I64, _I32] + [_P] * 10),
    "akort_manba_sync": (_SZ, [_SZ, _P, _SZ, _SZ, _P, _P, _P, _P, _P, _P, _P]),
    "akort_u8_to_planes": (None, [_P, _I32, _I32, _I32, _I32, _I32, _P]),
    "akort_tile_lift": (_I32, [_P, _I32, _I32, _I32, _I32, _I32, _P, _P, _P, _SZ]),
    "akort_tile_unlift": (_I32, [_P, _SZ, _I32, _I32, _I32, _I32, _I32, _P]),
    "akort_planes_to_u8": (None, [_P, _I32, _I32, _I32, _I32, _P]),
    "akort_tile_encode_block": (
        _SZ,
        [_P, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P, _P, _SZ, _P, _SZ, _P],
    ),
    "akort_tile_decode_block": (
        _I32,
        [_P, _SZ, _SZ, _SZ, _I32, _I32, _I32, _I32, _I32, _I32, _P],
    ),
    # image, row stride, channels, wavelet, wrap, color, discard, n, rects,
    # qg_off, qs, gs, counts, caps, out, out_off, sizes
    "akort_tile_encode_spans": (
        _I32,
        [_P, _I64, _I32, _I32, _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    ),
    # blob, pay_off, pay_size, counts, caps, n, rects, row stride,
    # channels, wavelet, wrap, color, image out
    "akort_tile_decode_spans": (
        _I32,
        [_P, _P, _P, _P, _P, _I32, _P, _I64, _I32, _I32, _I32, _I32, _P],
    ),
}


def _compile() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    cc = os.environ.get("CC", "cc")
    # pid-unique temp: concurrent processes (pytest-xdist workers) may
    # race to build; os.replace keeps the install atomic either way
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    opt = ["-O3", "-march=native"]
    base = ["-pthread", "-fPIC", "-shared", "-fvisibility=hidden", SRC, "-lm", "-o", tmp]
    try:
        subprocess.run([cc, *opt, *base], check=True, capture_output=True)
    except subprocess.CalledProcessError:
        # a compiler without -march=native builds the same code at -O2
        subprocess.run([cc, "-O2", *base], check=True, capture_output=True)
    os.replace(tmp, _LIB)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(SRC):
            _compile()
        lib = ctypes.CDLL(_LIB)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib

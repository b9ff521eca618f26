"""Process-global observability counters for silent-path events.

The same counters and names as ako_tpu/utils/metrics.py (copied: the
port imports nothing of ako_tpu). The device-entropy encoder falls back
to the exact host coder for tiles near capacity (encode.pack_budget),
and the device-entropy decoder falls back to the host for quirk streams
whose gamma codes exceed the decoder's 31-bit window. Both fallbacks
are bit-exact, so only these counters show a regression that routes
tiles onto the slow host path; chip_smoke.py holds the north star to
zero fallbacks.

Counters are process-global and thread-safe; `reset()` + `counters()`
bracket a measured region.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counters: dict[str, int] = {}

#: device packer tiles framed from device-compressed bytes
ENC_DEVICE = "enc_pack_device_tiles"
#: near-capacity tiles deferred to the host coder (encode.py)
ENC_HOST_FALLBACK = "enc_pack_host_fallback_tiles"
#: tiles entropy-decoded by the device program (Kagari or Manbavaran)
DEC_DEVICE = "dec_device_tiles"
#: quirk streams (gamma codes > 31 bits) decoded on host (decode.py)
DEC_HOST_FALLBACK = "dec_sync_host_fallback_tiles"


def bump(name: str, n: int = 1) -> None:
    if n <= 0:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """Snapshot of all counters (missing keys mean zero)."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()


def fallback_summary() -> dict[str, int]:
    """The four pipeline-placement counters, zeros included — the
    shape bench.py embeds as `fallbacks` in its JSON line."""
    c = counters()
    return {
        k: c.get(k, 0)
        for k in (ENC_DEVICE, ENC_HOST_FALLBACK, DEC_DEVICE, DEC_HOST_FALLBACK)
    }

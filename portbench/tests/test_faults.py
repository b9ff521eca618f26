"""A run of each cell at a small size on the CPU, with the look for a
card skipped: correct with the program as it is, and not correct with
the timed path broken underneath in each way the cell can be: an answer
altered where it is produced, and a step that returns its state
unchanged."""

import os
import time

import pytest

from portbench.harness.main import port_api, run
from portbench.harness.registry import Bench
from portbench.tests.conftest import ROOT, small_checkout


def flip(blob: bytes, at: int = -1) -> bytes:
    b = bytearray(blob)
    b[at] ^= 0x10
    return bytes(b)


def broken(api, fault: str):
    """api with its entry broken by `fault`."""
    import ako_tpu_torch

    encode, decode, ratio, stream = (getattr(api, "encode", ako_tpu_torch.encode),
                                     getattr(api, "decode", None),
                                     getattr(api, "encode_with_ratio", None),
                                     getattr(api, "roundtrip_iter", None))
    if fault == "blob_byte":
        api.encode = lambda *a, **k: flip(encode(*a, **k))
    elif fault == "pixel":
        def decode_one_off(*a, **k):
            img, s, c = decode(*a, **k)
            img = img.copy()
            img[-1, -1, 0] ^= 1
            return img, s, c
        api.decode = decode_one_off
    elif fault == "decode_returns_input":
        # the decode hands back the state it was given: the source image
        source = {}

        def encode_and_remember(image, *a, **k):
            blob = encode(image, *a, **k)
            source[blob] = image
            return blob
        api.encode = encode_and_remember
        api.decode = lambda blob, **k: (source[blob], None, None)
    elif fault == "q_off":
        api.encode_with_ratio = lambda *a, **k: (lambda r: (r[0], r[1] + 1))(ratio(*a, **k))
    elif fault == "q_unchanged":
        # the search returns the settings it was given, unsearched
        api.encode_with_ratio = lambda image, s, r, **k: (encode(image, s, **k), s.quantization)
    elif fault == "stream_blob_byte":
        api.roundtrip_iter = lambda *a, **k: ((flip(b, 40), p) for b, p in stream(*a, **k))
    elif fault == "stream_pixel":
        def one_off(*a, **k):
            for b, p in stream(*a, **k):
                p = p.copy()
                p[0, 0, 0] ^= 1
                yield b, p
        api.roundtrip_iter = one_off
    return api


CASES = [
    ("cafe_t128.single", None), ("cafe_t128.single", "blob_byte"),
    ("cafe_t128.single", "pixel"), ("tractor_whole.single", None),
    ("tractor_whole.single", "decode_returns_input"), ("tractor_whole.single", "blob_byte"),
    ("cafe_t128.stream", None), ("cafe_t128.stream", "stream_blob_byte"),
    ("cafe_t128.stream", "stream_pixel"), ("cafe_t128.rate12", None),
    ("cafe_t128.rate12", "q_off"), ("cafe_t128.rate12", "q_unchanged"),
]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(tmp_path, workload, fault):
    bench = Bench(small_checkout(tmp_path), os.path.join(ROOT, "portbench"))
    api = port_api(bench.loop(bench.traffic(bench.cell(workload)["traffic"])["loop"]).ENTRIES)
    if fault:
        api = broken(api, fault)
    out = run(bench, workload, 2**31 + 77, 0.6, False, time.perf_counter(), device="cpu", api=api,
              say=lambda *a: None)
    assert out["attempted"] > 0
    assert out["correct"] == (fault is None), out["compared"]

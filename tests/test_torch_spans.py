"""The port's spans (ako_tpu_torch/utils/tracing.py `span`) on the CPU:
where each opens, on which thread, and how many a call makes, read from
the span log (`recorded_spans`) under a profiler that records every
thread, and the same names in the profiler's own events; that with no
profiler `span` is the one shared null context and builds no profiler
range (record_function or its function-scope kind) on any path; and
that an AKO_TPU_TRACE_DIR trace holds the scan pool's spans; and the
tile scans that native threads log. Images from numpy seeds
(utils/corpus.py)."""

import collections
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

import ako_tpu_torch
from ako_tpu_torch import Compression, Settings
from ako_tpu_torch.core import geometry
from ako_tpu_torch.parallel import make_mesh
from ako_tpu_torch.parallel import tiles as ptiles
from ako_tpu_torch.runtime.executor import roundtrip_iter
from ako_tpu_torch.tools import rate
from ako_tpu_torch.utils import tracing
from ako_tpu_torch.utils.corpus import corpus

# 40x32 at 16-px tiles: 6 tiles in two shape groups
S16 = Settings(quantization=16, tiles_dimension=16)
S16_MANBA = dataclasses.replace(S16, compression=Compression.MANBAVARAN)


def _rgba(seed=61, n=1):
    return corpus(seed, n, 32, 40, 4)


def _ratio_image():
    img = corpus(11, 1, 48, 64, 4)[0][:, :, :3]
    noise = np.random.default_rng(11).normal(0, 4.0, img.shape)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


class Recorded:
    """The spans logged while the block ran under a profiler of every
    thread, and the names of the profiler's own `ako.*` ranges."""

    def __enter__(self):
        self.t0 = time.time_ns()
        self.prof = profile(activities=[ProfilerActivity.CPU],
                            experimental_config=_ExperimentalConfig(profile_all_threads=True))
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.spans = tracing.recorded_spans(self.t0)
        self.events = collections.Counter(
            e.name() for e in self.prof.profiler.kineto_results.events()
            if e.name().startswith("ako."))
        return False

    def named(self, name):
        return [s for s in self.spans if s[0] == name]

    def counts(self):
        return collections.Counter(s[0] for s in self.spans)


def _encode(img):
    return ako_tpu_torch.encode(img, S16, device="cpu", device_entropy=True)


def _decode(blob):
    return ako_tpu_torch.decode(blob, device="cpu", device_entropy=True)[0]


def test_encode_source_span():
    img = _rgba()[0]
    with Recorded() as rec:
        _encode(img)
    assert rec.counts() == {"ako.encode.dispatch": 1, "ako.encode.source": 1}
    (_, tid, a, b), = rec.named("ako.encode.source")
    (_, dispatch_tid, da, db), = rec.named("ako.encode.dispatch")
    assert tid == dispatch_tid == threading.get_native_id() and da <= a <= b <= db


def test_decode_scan_spans_on_the_pool():
    """Under MANBAVARAN settings the scans run a tile a task on the scan
    pool (reserved-flag Kagari bytes here, tried as rANS first)."""
    img = _rgba()[0]
    blob = ako_tpu_torch.encode(img, S16_MANBA, device="cpu", device_entropy=True)
    with Recorded() as rec:
        assert (_decode(blob) == img).any()
    n_tiles = len(geometry.tile_grid(40, 32, 16))
    (_, main, a, b), = rec.named("ako.decode.scan")
    tiles = rec.named("ako.decode.scan_tile")
    assert len(tiles) == n_tiles == 6
    names = {t.native_id: t.name for t in threading.enumerate()}
    for _, tid, ta, tb in tiles:
        assert a <= ta <= tb <= b
        assert tid != main and names[tid].startswith("ako-sync")
    assert rec.counts() == {"ako.decode.scan": 1, "ako.decode.scan_tile": n_tiles}


@pytest.mark.parametrize("route", ["decode", "sharded"])
def test_native_scan_tile_spans(monkeypatch, route):
    """A Kagari image's scans run in one native call: one
    ako.decode.scan_tile a tile, logged from the C side's clocks, inside
    the decode's scan span, on native threads that are neither the
    caller's nor a Python thread, at most os.cpu_count() of them."""
    monkeypatch.setattr(os, "cpu_count", lambda: 4)
    img = _rgba()[0]
    blob = _encode(img)
    scan = "ako.decode.scan" if route == "decode" else "ako.shard.decode.scan"
    with Recorded() as rec:
        if route == "decode":
            got = _decode(blob)
        else:
            mesh = make_mesh((2,), ("tiles",), devices=[torch.device("cpu")] * 2)
            got = ptiles.decode_image_sharded(blob, mesh, device_entropy=True)[0]
    assert (got == ako_tpu_torch.decode(blob, device="cpu")[0]).all()
    (_, main, a, b), = rec.named(scan)
    tiles = rec.named("ako.decode.scan_tile")
    assert len(tiles) == len(geometry.tile_grid(40, 32, 16)) == 6
    python_threads = {t.native_id for t in threading.enumerate()}
    assert main == threading.get_native_id()
    for _, tid, ta, tb in tiles:
        assert a <= ta <= tb <= b
        assert tid not in python_threads
    assert 1 <= len({tid for _, tid, _, _ in tiles}) <= 4


def test_roundtrip_spans():
    images = _rgba(62, 4)
    with Recorded() as rec:
        out = list(roundtrip_iter(images, S16, device="cpu", device_entropy=True))
    assert len(out) == 4
    counts = rec.counts()
    for side in ("enc", "dec"):
        assert counts[f"ako.exec.{side}.dispatch"] == 4
        assert counts[f"ako.exec.{side}.collect"] == 4
    assert counts["ako.exec.wait_put"] == 4
    assert counts["ako.exec.wait_blob"] == 5  # the last get takes the end of the stream
    # the encoder's dispatch, the puts and the collects are off the consumer's thread
    main = threading.get_native_id()
    for name in ("ako.exec.enc.dispatch", "ako.exec.wait_put", "ako.exec.enc.collect",
                 "ako.exec.dec.collect"):
        assert all(tid != main for _, tid, _, _ in rec.named(name)), name
    for name in ("ako.exec.dec.dispatch", "ako.exec.wait_blob"):
        assert all(tid == main for _, tid, _, _ in rec.named(name)), name


def test_rate_search_spans(monkeypatch):
    probes, variants = [], []
    size_at, pyramids = rate._CachedEncoder.size_at, rate._CachedEncoder._tile_pyramids

    def counted_size_at(self, q):
        probes.append(q)
        return size_at(self, q)

    def seen_pyramids(self, s):
        variants.append(s.color)
        return pyramids(self, s)

    monkeypatch.setattr(rate._CachedEncoder, "size_at", counted_size_at)
    monkeypatch.setattr(rate._CachedEncoder, "_tile_pyramids", seen_pyramids)
    with Recorded() as rec:
        rate.encode_with_ratio(_ratio_image(), Settings(tiles_dimension=32), 4, device="cpu")
    counts = rec.counts()
    assert counts["ako.rate.probe"] == len(probes) > 1
    assert counts["ako.rate.pyramid"] == len(set(variants)) >= 1
    assert counts["ako.rate.final"] == 1
    assert set(counts) == {"ako.rate.probe", "ako.rate.pyramid", "ako.rate.final"}
    probe_spans = rec.named("ako.rate.probe")
    _, _, first_a, first_b = probe_spans[0]
    (_, _, pa, pb) = rec.named("ako.rate.pyramid")[0]
    assert first_a <= pa <= pb <= first_b
    for _, _, a, b in rec.named("ako.rate.pyramid"):
        assert any(p0 <= a <= b <= p1 for _, _, p0, p1 in probe_spans)
    (_, _, fa, _), = rec.named("ako.rate.final")
    assert fa >= probe_spans[-1][3]


@pytest.mark.parametrize("call", ["encode", "decode", "roundtrip"])
def test_profiler_events_carry_the_logged_spans(call):
    """The profiler's own ranges, on every thread, match the log, but for
    the tile scans that the native scan logs, which no range carries (6
    tiles an image)."""
    img = _rgba()[0]
    blob = _encode(img)
    with Recorded() as rec:
        if call == "encode":
            _encode(img)
        elif call == "decode":
            _decode(blob)
        else:
            list(roundtrip_iter(_rgba(63, 2), S16, device="cpu", device_entropy=True))
    native = collections.Counter({"ako.decode.scan_tile": {"encode": 0, "decode": 6,
                                                           "roundtrip": 12}[call]})
    assert rec.counts()["ako.decode.scan_tile"] == native["ako.decode.scan_tile"]
    assert rec.events == rec.counts() - native and rec.events


def _no_record_function(monkeypatch):
    """Every kind of profiler range made to fail and be counted."""
    built = []

    def record_function(*a, **k):
        built.append(a)
        raise AssertionError("a profiler range built with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", record_function)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", record_function)
    return built


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    built = _no_record_function(monkeypatch)
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = tracing.span("ako.decode.scan"), tracing.span("ako.rate.probe")
    assert a is b
    with a:
        pass
    assert built == []


@pytest.mark.parametrize("path", ["encode_decode", "roundtrip", "rate"])
def test_no_record_function_on_any_path_without_a_profiler(monkeypatch, path):
    built = _no_record_function(monkeypatch)
    t0 = time.time_ns()
    if path == "encode_decode":
        img = _rgba()[0]
        assert (_decode(_encode(img)) == ako_tpu_torch.decode(_encode(img), device="cpu")[0]).all()
    elif path == "roundtrip":
        assert len(list(roundtrip_iter(_rgba(64, 3), S16, device="cpu",
                                       device_entropy=True))) == 3
    else:
        rate.encode_with_ratio(_ratio_image(), Settings(tiles_dimension=32), 4, device="cpu")
    assert built == []
    assert [s for s in tracing.recorded_spans(t0) if s[0].startswith("ako.")] == []


def test_trace_dir_holds_the_scan_pool_spans(monkeypatch, tmp_path):
    """AKO_TPU_TRACE_DIR's trace of a decode records every thread: the
    scans' spans on the pool's threads beside the decode's own (the
    pool's: MANBAVARAN settings)."""
    blob = ako_tpu_torch.encode(_rgba()[0], S16_MANBA, device="cpu", device_entropy=True)
    monkeypatch.setenv("AKO_TPU_TRACE_DIR", str(tmp_path))
    _decode(blob)
    (path,) = tmp_path.glob("decode-*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if str(e.get("name", "")).startswith("ako.")]
    scan = [e for e in events if e["name"] == "ako.decode.scan"]
    tiles = [e for e in events if e["name"] == "ako.decode.scan_tile"]
    assert len(scan) == 1 and len(tiles) == 6
    assert {e["tid"] for e in tiles}.isdisjoint({scan[0]["tid"]})

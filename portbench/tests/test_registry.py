"""A configuration, a traffic mix, a loop, an end-to-end metric and a
per-layer metric added as new files, and entries in BENCHMARK.json, are
found by name: no file of the harness changes."""

import json
import os
import shutil
import time

from portbench.harness.main import run
from portbench.harness.registry import Bench
from portbench.tests.conftest import ROOT, load_config

BENCH = os.path.join(ROOT, "portbench")

#: a new kind of traffic: encodes only, one client
ENCODE_ONLY = '''
import itertools, time
from portbench.harness.traffic import Loop as Base, Result

ENTRIES = {"encode": "ako_tpu_torch:encode"}


class Loop(Base):
    def warm(self):
        self.api.encode(self.pool[0], self.settings, device=self.device)

    def window(self, seconds, traced, annotate):
        res, end = Result(), time.perf_counter() + seconds
        for i in itertools.count():
            if time.perf_counter() >= end:
                break
            k = i % len(self.pool)
            res.attempted += 1
            blob, req = self._timed("encode", lambda ev: self.api.encode(
                self.pool[k], self.settings, events=ev, device=self.device), traced, annotate)
            res.requests.append(req)
            res.kept.append((k, {"blob": blob}))
        res.seconds = seconds
        return res


def reference(enc, mix):
    return {"blob": enc.blob_at(enc.base.quantization)}
'''


def new_checkout(tmp_path):
    base = tmp_path / "portbench"
    for sub in ("loops", "metrics", "layers"):
        shutil.copytree(os.path.join(BENCH, sub), base / sub)
    for sub in ("configs", "traffic"):
        os.makedirs(base / sub)
    cfg = dict(load_config("tractor_whole"), name="gray96", width=96, height=80, pool_images=2)
    (base / "configs" / "gray96.json").write_text(json.dumps(cfg))
    (base / "traffic" / "twice.json").write_text(json.dumps({"loop": "closed"}))
    (base / "traffic" / "encodes.json").write_text(json.dumps({"loop": "encode_only"}))
    (base / "loops" / "encode_only.py").write_text(ENCODE_ONLY)
    (base / "metrics" / "encode_p50_ms.py").write_text(
        "import numpy as np\n\ndef read(result, mix, config):\n"
        "    return float(np.median(result.ms_of('encode')))\n")
    (base / "layers" / "decodes_seen.py").write_text(
        "def read(window):\n    return len(window.requests_of('decode')) or None\n")
    spec = {
        "configs": [{"name": "gray96", "file": "portbench/configs/gray96.json"}],
        "workloads": [{"name": "gray96.twice", "config": "gray96", "traffic": "twice",
                       "chips": 1},
                      {"name": "gray96.encodes", "config": "gray96", "traffic": "encodes",
                       "chips": 1}],
        "end_to_end": [{"name": "decode_p95_ms", "unit": "ms", "workloads": ["gray96.twice"]},
                       {"name": "encode_p50_ms", "unit": "ms"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "decodes_seen", "unit": "requests", "workloads": ["gray96.twice"]},
                      {"name": "k8p_roofline", "unit": "%", "workloads": ["other.cell"]}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(str(tmp_path))


def test_new_files_are_found_by_name(tmp_path):
    bench = new_checkout(tmp_path)
    assert bench.config("gray96")["width"] == 96
    assert [m["name"] for m in bench.per_layer("gray96.twice")] == ["decodes_seen"]
    said = []
    out = run(bench, "gray96.twice", 2**31 + 9, 0.5, False, time.perf_counter(), device="cpu",
              say=said.append)
    assert out["correct"]
    assert set(out["metrics"]) == {"decode_p95_ms", "encode_p50_ms", "setup_s"}
    traced = run(bench, "gray96.twice", 2**31 + 9, 0.5, True, time.perf_counter(),
                 device="cpu", say=said.append)
    assert traced["correct"]
    assert traced["metrics"]["decodes_seen"]["value"] == traced["attempted"]


def test_new_loop_is_found_by_name(tmp_path):
    bench = new_checkout(tmp_path)
    out = run(bench, "gray96.encodes", 2**31 + 10, 0.5, False, time.perf_counter(),
              device="cpu", say=lambda *a: None)
    assert out["correct"] and set(out["compared"]) == {"failed", "blob_bytes_off"}
    assert set(out["metrics"]) == {"encode_p50_ms", "setup_s"}


def test_the_benchmark_names_files_that_exist():
    bench = Bench(ROOT)
    for w in bench.spec["workloads"]:
        bench.config(w["config"])
        loop = bench.loop(bench.traffic(w["traffic"])["loop"])
        assert loop.ENTRIES and callable(loop.reference)
        for m in bench.end_to_end(w["name"]):
            assert callable(bench.metric(m["name"]))
        for m in bench.per_layer(w["name"]):
            assert callable(bench.reader(m["name"]))

"""The cell tractor_t128.sharded4 on the CPU at a reduced size: the
`sharded` loop through harness.main.run on a mesh of the CPU repeated,
correct with the program as it is and not correct with an answer broken;
the control not correct; and each of the cell's new readers on a
synthetic window with known spans, on a program that logs none, and on a
traced CPU window (a number, or None where it reads the cards' time)."""

import json
import os
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from ako_tpu_torch.utils import metrics, tracing
from portbench.control import control_numbers
from portbench.harness import check
from portbench.harness.main import port_api, port_settings, run
from portbench.harness.pool import make_pool
from portbench.harness.registry import Bench
from portbench.tests.conftest import ROOT, load_config
from portbench.tests.test_faults import broken
from portbench.tests.test_spans import log_of, window

CELL = "tractor_t128.sharded4"
BENCH = Bench(ROOT)
NEW = [m["name"] for m in BENCH.per_layer(CELL)]
#: the reader of the cards' kernel time, which a CPU window gives nothing to
DEVICE = ("k4_roofline.sharded4",)
#: 224x152 at 128-px tiles: one tile in each of the 4 shape groups, so
#: 3 pad tiles a group over 4 shards
SIZE = (224, 152)


def checkout(tmp_path, device_entropy: bool) -> Bench:
    """BENCHMARK.json and the configurations, the tractor's at SIZE with
    2 pool images; with device_entropy, the decode takes the card's route
    (its sync scans and plain K4), the CPU's default being the host's."""
    os.makedirs(tmp_path / "portbench" / "configs")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    for name in ("cafe_t128", "tractor_whole"):
        shutil.copy(os.path.join(ROOT, "portbench", "configs", f"{name}.json"),
                    tmp_path / "portbench" / "configs")
    cfg = dict(load_config("tractor_t128"), width=SIZE[0], height=SIZE[1], pool_images=2)
    if device_entropy:
        cfg["entry_options"] = {"device_entropy": True}
    with open(tmp_path / "portbench" / "configs" / "tractor_t128.json", "w") as f:
        json.dump(cfg, f)
    return Bench(str(tmp_path), os.path.join(ROOT, "portbench"))


def test_the_cell_is_four_chips_and_reads_its_decode():
    cell = BENCH.cell(CELL)
    assert (cell["chips"], BENCH.traffic(cell["traffic"])["shards"]) == (4, 4)
    assert {m["name"] for m in BENCH.end_to_end(CELL)} == {"decode_p95_ms", "setup_s"}
    assert {m["moves"] for m in BENCH.per_layer(CELL)} == {"decode_p95_ms"}
    cfg = load_config("tractor_t128")
    assert cfg["reduced"] == [] and cfg["settings"]["tiles_dimension"] == 128


@pytest.mark.parametrize("fault", [None, "blob_byte", "pixel"])
def test_the_loop_on_the_cpu(tmp_path, fault):
    bench = checkout(tmp_path, False)
    api = port_api(bench.loop("sharded").ENTRIES)
    if fault:
        api = broken(api, fault)
    metrics.reset()
    out = run(bench, CELL, 2**31 + 401, 0.5, False, time.perf_counter(), device="cpu", api=api,
              say=lambda *a: None)
    assert out["attempted"] > 0 and out["device"]["count"] == 4
    assert out["correct"] == (fault is None), out["compared"]
    assert set(out["metrics"]) == {m["name"] for m in bench.end_to_end(CELL)}
    c = metrics.counters()  # each call: 4 real tiles and 12 pad tiles
    assert c[metrics.SHARD_PAD_TILES] == 3 * c[metrics.SHARD_TILES] > 0


def test_set_up_warms_every_pool_image(tmp_path):
    """Each pool image is encoded, and its blob decoded, once in set-up."""
    bench = checkout(tmp_path, False)
    config = bench.config("tractor_t128")
    real = port_api(bench.loop("sharded").ENTRIES)
    seen = []

    def encode(image, settings, mesh):
        seen.append(("encode", id(image)))
        return real.encode(image, settings, mesh)

    def decode(blob, mesh, **kw):
        seen.append(("decode", blob))
        return real.decode(blob, mesh, **kw)

    api = SimpleNamespace(make_mesh=real.make_mesh, encode=encode, decode=decode,
                          AkoError=real.AkoError)
    pool = make_pool(config, 2**31 + 404, "cpu")
    loop = bench.loop("sharded").Loop(bench.traffic("sharded4"), config, api, pool,
                                      port_settings(config["settings"]), 2**31 + 404, "cpu")
    loop.warm()
    assert [k for k, _ in seen] == ["encode", "decode"] * len(pool) and len(pool) == 2
    assert [v for k, v in seen if k == "encode"] == [id(image) for image in pool]


def test_the_control_fails(tmp_path):
    bench = checkout(tmp_path, False)
    config = bench.config("tractor_t128")
    mix = bench.traffic("sharded4")
    pool = make_pool(config, 2**31 + 403, "cpu")
    answer = bench.loop("sharded").reference
    numbers = control_numbers(config, mix, answer, pool, torch.device("cpu"))
    assert not check.is_correct(numbers), numbers


def test_traced_window_gives_each_reader_a_number(tmp_path):
    bench = checkout(tmp_path, True)
    out = run(bench, CELL, 2**31 + 402, 2.0, True, time.perf_counter(), device="cpu",
              say=lambda *a: None)
    assert out["correct"], out["compared"]
    for name in NEW:
        if name in DEVICE:
            assert name not in out["metrics"], name
        elif name == "device_idle.sharded4":
            assert out["metrics"][name]["value"] == 100.0  # no card ran anything
        else:
            assert out["metrics"][name]["value"] > 0, name


# (name, thread, start µs, end µs): two encodes and two decodes
LOG = [
    ("ako.shard.encode", 1, 100, 900),
    ("ako.shard.decode", 1, 1000, 2000),
    ("ako.shard.decode.scan", 1, 1010, 1500),
    ("ako.shard.decode.dispatch", 1, 1500, 1600),
    ("ako.shard.decode.dispatch", 1, 1600, 1650),
    ("ako.shard.decode.place", 1, 1650, 1800),
    ("ako.shard.decode.place", 1, 1800, 1950),
    ("ako.shard.encode", 1, 2100, 2500),
    ("ako.shard.decode", 1, 2600, 3400),
    ("ako.shard.decode.scan", 1, 2610, 2900),
    ("ako.shard.decode.dispatch", 1, 2900, 3000),
    ("ako.shard.decode.place", 1, 3000, 3350),
    ("ako.shard.decode.scan", 1, 3600, 3700),  # in no decode
]
EXPECTED = {
    "shard_dec_scan_ms": 0.39,  # (490 + 290) µs over 2 decodes
    "shard_dec_dispatch_ms": 0.125,
    "shard_dec_place_ms": 0.325,
    "device_idle.sharded4": 50.0,  # 1650 of 3300 µs busy
    "k4_roofline.sharded4": None,
}


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(tracing, "recorded_spans", log_of(LOG))
    return window({"portbench.window": [(0, 4000)],
                   "portbench.encode": [(90, 950), (2050, 2550)],
                   "portbench.decode": [(960, 2040), (2560, 3420)]},
                  device=[(90, 950, "k"), (960, 1320, "k"), (2990, 3420, "k")])


def test_every_reader_is_listed():
    assert sorted(EXPECTED) == sorted(NEW)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_known_spans(synthetic, name):
    got = BENCH.reader(name)(synthetic)
    assert got == (None if EXPECTED[name] is None else pytest.approx(EXPECTED[name]))


@pytest.mark.parametrize("name", [n for n in sorted(EXPECTED) if n.startswith("shard_")])
def test_reader_without_program_spans(monkeypatch, synthetic, name):
    """A program that logs no spans (the parent's): None, no error."""
    monkeypatch.setattr(tracing, "recorded_spans", lambda since_ns=0: [])
    assert BENCH.reader(name)(synthetic) is None

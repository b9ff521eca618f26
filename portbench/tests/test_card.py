"""On the card: a short run of each cell through the command the driver
uses, correct, with the result line's keys."""

import json
import os
import subprocess
import sys

import pytest

from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs(card, workload, traced):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed",
                          str(2**31 + 1), "--seconds", "2", "--trace", str(traced)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "compared"

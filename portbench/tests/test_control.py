"""The check's control, the reference at int8 in the program's place,
comes out not correct; the reference at its own precision compares
exactly with itself."""

import pytest
import torch

from portbench.control import control_numbers
from portbench.harness import check
from portbench.harness.pool import make_pool
from portbench.harness.registry import Bench
from portbench.tests.conftest import load_config


@pytest.mark.parametrize("workload", ["cafe_t128.single", "tractor_whole.single",
                                      "cafe_t128.rate12"])
def test_control_fails(workload, tmp_path):
    from portbench.tests.conftest import ROOT, small_checkout

    bench = Bench(small_checkout(tmp_path, pool=2), f"{ROOT}/portbench")
    cell = bench.cell(workload)
    config, mix = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    pool = make_pool(config, 2**31 + 3, "cpu")
    answer = bench.loop(mix["loop"]).reference
    numbers = control_numbers(config, mix, answer, pool, torch.device("cpu"))
    assert not check.is_correct(numbers), numbers
    expected = check.Expected(config, mix, pool, torch.device("cpu"), answer)
    same = check.compare([(k, expected(k)) for k in range(len(pool))], 0, expected)
    assert check.is_correct(same) and set(same) == set(numbers)


def test_config_files_state_their_source():
    for name in ("cafe_t128", "tractor_whole"):
        cfg = load_config(name)
        assert cfg["source"] and cfg["assumed"] and cfg["reduced"] == []

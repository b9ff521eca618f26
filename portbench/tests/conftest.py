"""CPU tests of the benchmark (portbench/). Tests that need the card are
marked `card` and skip without one; on the card:

    python -m pytest portbench/tests -m card -o addopts=""
"""

import json
import os
import shutil

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: reduced image sizes for the CPU: (width, height) of each configuration,
#: odd sides and border tiles included
SMALL = {"cafe_t128": [(200, 136), (256, 384)], "tractor_whole": [(163, 246)]}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")


def load_config(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def small_checkout(tmp_path, pool: int = 2) -> str:
    """A directory with BENCHMARK.json and portbench's configs at the
    first SMALL size, `pool` images each; the harness's own files are
    read from the repository."""
    os.makedirs(tmp_path / "portbench" / "configs")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    for name, sizes in SMALL.items():
        cfg = load_config(name)
        cfg.update(width=sizes[0][0], height=sizes[0][1], pool_images=pool)
        with open(tmp_path / "portbench" / "configs" / f"{name}.json", "w") as f:
            json.dump(cfg, f)
    return str(tmp_path)

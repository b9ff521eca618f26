"""What the benchmark may import, and that it fails without a card."""

import ast
import os
import shutil
import subprocess
import sys
import types


from portbench.harness.main import FORBIDDEN, forbidden_modules
from portbench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(under: str) -> list:
    return [os.path.join(d, f) for d, _, files in os.walk(under) for f in files
            if f.endswith(".py")]


def test_no_jax_anywhere():
    for path in sources(BENCH):
        assert not top_level_imports(path) & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, "reference")):
        assert top_level_imports(path) <= {"__future__", "math", "struct", "dataclasses",
                                           "numpy", "torch"}, path


def test_names_compare_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert "ako_tpu_torch" in sys.modules
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ako_tpu.encode", types.ModuleType("ako_tpu.encode"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert forbidden_modules() == ["ako_tpu", "jax"]


def run_bench(cwd: str):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "cafe_t128.single", "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def assert_no_result(res):
    assert res.returncode != 0
    assert not [line for line in res.stdout.splitlines() if line.startswith("{")]


def test_fails_without_a_card():
    assert_no_result(run_bench(ROOT))


def test_fails_with_only_its_own_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench")
    assert_no_result(run_bench(str(tmp_path)))

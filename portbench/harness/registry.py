"""BENCHMARK.json and the files it names, found by name.

Under the benchmark's directory: a configuration is `configs/<config>.json`
(the path BENCHMARK.json gives as its `file`), a traffic mix
`traffic/<mix>.json` whose `loop` names `loops/<loop>.py`, an end-to-end
metric `metrics/<metric>.py` with `read(result, mix, config)`, and a
per-layer metric `layers/<metric>.py` with `read(window)`. A later change
adds any of them by adding such files and entries; nothing in harness/
names one.
"""

from __future__ import annotations

import importlib.util
import json
import os


class Bench:
    """The benchmark's specification (BENCHMARK.json at `root`) and the
    directory `base` that holds its configs/, traffic/, loops/, metrics/
    and layers/."""

    def __init__(self, root: str, base: str | None = None):
        self.root = root
        self.base = base or os.path.join(root, "portbench")
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)
        self._modules: dict = {}

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.base, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def _for(self, kind: str, cell: str) -> list:
        return [m for m in self.spec[kind] if cell in m.get("workloads", [cell])]

    def end_to_end(self, cell: str) -> list:
        """The end-to-end metrics the cell reports."""
        return self._for("end_to_end", cell)

    def per_layer(self, cell: str) -> list:
        """The per-layer metrics the cell's traced run reports."""
        return self._for("per_layer", cell)

    def _module(self, sub: str, name: str):
        key = (sub, name)
        if key not in self._modules:
            path = os.path.join(self.base, sub, f"{name}.py")
            spec = importlib.util.spec_from_file_location(f"portbench_{sub}_{name}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            self._modules[key] = module
        return self._modules[key]

    def loop(self, name: str):
        """loops/<name>.py: its ENTRIES, Loop and reference."""
        return self._module("loops", name)

    def metric(self, name: str):
        """The `read(result, mix, config)` function of metrics/<name>.py."""
        return self._module("metrics", name).read

    def reader(self, metric: str):
        """The `read(window)` function of layers/<metric>.py."""
        return self._module("layers", metric).read

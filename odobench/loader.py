"""Everything of a cell found by name, so that a later change adds a
configuration, a traffic mix, a limit set, a per-layer metric or a
kernel's layer as a new file:

- ``configs/<config>.json``: a configuration (sensor and algorithm);
- ``traffic/<traffic>.json``: a traffic mix (the drive, the loop);
- ``limits/<workload>.json``: the correctness check's limits of a cell;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``;
- ``kernels/<kernel>.json``: ``{"pattern": regex, "layer": name}``.

``BENCHMARK.json`` sits beside the benchmark's folder.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent


class Loader:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)

    def _json(self, *parts) -> dict:
        path = self.root.joinpath(*parts)
        if not path.is_file():
            raise FileNotFoundError(f"odobench: {path} is missing")
        return json.loads(path.read_text())

    def benchmark(self) -> dict:
        path = self.root.parent / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"odobench: {path} is missing")
        return json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.benchmark()["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"odobench: no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", f"{name}.json")

    def traffic(self, name: str) -> dict:
        return self._json("traffic", f"{name}.json")

    def limits(self, workload: str) -> dict:
        return self._json("limits", f"{workload}.json")

    def metrics(self, workload: str, trace: bool) -> list:
        """The metrics a run of ``workload`` reports: its end-to-end ones
        with ``trace`` off, else its per-layer ones (an entry with a
        ``workloads`` key only where it lists the cell)."""
        b = self.benchmark()
        entries = b["per_layer"] if trace else b["end_to_end"]
        return [m for m in entries if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The ``read(run)`` function of ``metrics/<metric>.py``."""
        path = self.root / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise FileNotFoundError(f"odobench: no reader {path}")
        spec = importlib.util.spec_from_file_location(f"odobench_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read

    def kernel_layers(self) -> list:
        """[(compiled pattern, layer)] of every ``kernels/*.json``, in
        file-name order."""
        out = []
        for path in sorted((self.root / "kernels").glob("*.json")):
            entry = json.loads(path.read_text())
            out.append((re.compile(entry["pattern"]), entry["layer"]))
        return out

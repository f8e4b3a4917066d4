"""Everything a run takes from files, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix and
lists the metrics; each configuration is ``gpbench/configs/<file>`` (as
``BENCHMARK.json`` gives it), each mix ``gpbench/traffic/<mix>.json``, each
cell's correctness limits ``gpbench/limits/<cell>.json``, each metric's
reader ``gpbench/metrics/<metric>.py`` (a ``read(run)`` that returns the
value, or None where the run has nothing to read), and each mix's driver
``gpbench/harness/drivers/<driver>.py``.  A new configuration, mix, cell or
metric is new files and new entries, with no edit to any file here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Spec:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "gpbench"
        self.benchmark = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.benchmark["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.benchmark["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench_dir / "limits" / f"{cell}.json").read_text())

    def metrics_for(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
        entries = self.benchmark["per_layer" if trace else "end_to_end"]
        return [m for m in entries if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        return _load(self.bench_dir / "metrics" / f"{metric}.py", f"gpbench_metric_{metric}").read

    def driver(self, name: str):
        return _load(self.bench_dir / "harness" / "drivers" / f"{name}.py",
                     f"gpbench_driver_{name}")


def _load(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name.replace(".", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

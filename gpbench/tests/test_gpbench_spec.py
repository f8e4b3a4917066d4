"""A configuration, a mix, a cell, its limits and a metric added as files
are found by name, with no edit to any file already there."""

import json
import shutil

from gpbench.harness import cell as cells
from gpbench.harness.spec import ROOT, Spec


def copy_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_files_are_found_by_name(tmp_path):
    root = copy_benchmark(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "gpbench/configs/exact-matern52-kin40k.json").read_text())
    cfg.update(name="exact-rbf-toy", kernel_type="rbf", n=256)
    (root / "gpbench/configs/exact-rbf-toy.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "gpbench/traffic/fit.json").read_text())
    mix.update(lr=0.05, compare_steps=2)
    (root / "gpbench/traffic/fit-slow.json").write_text(json.dumps(mix))
    (root / "gpbench/limits/toy-train.json").write_text(json.dumps({"loss_gap": 1.0}))
    (root / "gpbench/metrics/steps_done.py").write_text(
        "def read(run):\n    return float(run.records['steps'])\n")
    bench["configs"].append({"name": "exact-rbf-toy", "source": "a test",
                             "file": "gpbench/configs/exact-rbf-toy.json", "reduced": ["n"],
                             "why": "a test"})
    bench["workloads"].append({"name": "toy-train", "config": "exact-rbf-toy",
                               "traffic": "fit-slow", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "training driver",
                               "moves": "train_step_ms", "workloads": ["toy-train"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_step_ms":
            m["workloads"].append("toy-train")  # an entry added, no file edited
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(root)
    assert spec.cell("toy-train")["traffic"] == "fit-slow"
    assert spec.config("exact-rbf-toy")["kernel_type"] == "rbf"
    assert spec.traffic("fit-slow")["compare_steps"] == 2
    assert spec.limits("toy-train") == {"loss_gap": 1.0}
    assert [m["name"] for m in spec.metrics_for("toy-train", True)] == ["steps_done"]
    assert [m["name"] for m in spec.metrics_for("toy-train", False)] == ["train_step_ms",
                                                                         "setup_s"]
    run = cells.Run(cell={}, config={}, traffic={}, records={"steps": 7}, setup_s=1.0,
                    trace=None, registry=None)
    assert spec.reader("steps_done")(run) == 7.0
    assert spec.driver("fit").run is not None


def test_every_listed_file_exists():
    spec = Spec()
    b = spec.benchmark
    for c in b["configs"]:
        assert spec.config(c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        spec.traffic(w["traffic"])
        assert spec.limits(w["name"])
        assert (spec.bench_dir / "harness/drivers" /
                f"{spec.traffic(w['traffic'])['driver']}.py").exists()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(spec.reader(m["name"]))

"""Whole runs on the CPU at a size a test run holds: the result line's keys,
a sound run judged correct, and the timed path broken underneath — a step
that returns its state unchanged, half of the data left out, an answer
altered where it is produced — judged not correct.  The control (the
reference one precision below the configuration's in the program's place)
separates from the program by three times or more.

Every cell of ``BENCHMARK.json`` runs with its own limits.  Both drivers
run besides in a copy of the benchmark that holds a cell of each driver and
configuration (``PROBES``); a probe cell that ``BENCHMARK.json`` lacks is
held to the limits given here, which test the mechanics only.

The CPU runs the program's plain paths (``ExactGP(mode="cuda",
device="cpu")``); the card's kernels are held to the limits by the
benchmark's own runs on the card.
"""

import json
import shutil
import warnings

import pytest

from gpbench.harness import cell as cells
from gpbench.harness.spec import ROOT, Spec

SMALL = {
    "fit": {"config": {"n": 300}},
    "serve": {"config": {"n": 400},
              "traffic": {"query_points": 64, "observe_rows": 8, "observe_period_s": 0.2}},
}
SECONDS = {"fit": 0.5, "serve": 3.0}
SEED = 2 ** 33 + 12345  # beyond 32 signed bits, as the driver's seeds are
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
CONTROL = {"highest": "tf32", "mixed": "fp8"}
#: a cell of each driver and configuration, with the limits a probe cell
#: that BENCHMARK.json lacks is held to
PROBE_LIMITS = {
    ("fit", "exact-matern52-kin40k"): {"start_gap": 0.0, "loss_gap": 1e-4, "grad_gap": 1e-4,
                                       "change_gap": 1e-4},
    ("fit", "exact-matern52-kin40k-mixed"): {"start_gap": 0.0, "loss_gap": 1e-2,
                                             "grad_gap": 1e-2, "change_gap": 1e-2},
    ("serve", "exact-matern52-kin40k"): {"query_mean_gap": 1e-4, "query_var_gap": 1e-4,
                                         "build_mean_gap": 1e-3, "gram_gap": 1e-4,
                                         "append_mean_gap": 1e-3},
    ("serve", "exact-matern52-kin40k-mixed"): {"query_mean_gap": 3e-2, "query_var_gap": 1e-4,
                                               "build_mean_gap": 3e-2, "gram_gap": 1e-4,
                                               "append_mean_gap": 3e-2},
}
PROBES = {
    ("fit", "exact-matern52-kin40k"): "kin40k-train",
    ("fit", "exact-matern52-kin40k-mixed"): "kin40k-mixed-train",
    ("serve", "exact-matern52-kin40k"): "kin40k-serve",
    ("serve", "exact-matern52-kin40k-mixed"): "kin40k-mixed-serve",
}
TRAFFIC = {"fit": "fit", "serve": "stream"}


@pytest.fixture(scope="module")
def probe_spec(tmp_path_factory):
    """A copy of the benchmark holding every probe cell."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "gpbench", root / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    have = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for (driver, config), name in PROBES.items():
        if config not in configs:
            configs.add(config)
            bench["configs"].append({"name": config, "source": "a test", "reduced": [],
                                     "file": f"gpbench/configs/{config}.json", "why": "a test"})
        if name not in have:
            bench["workloads"].append({"name": name, "config": config, "chips": 1,
                                       "traffic": TRAFFIC[driver], "why": "a test"})
            (root / "gpbench/limits" / f"{name}.json").write_text(
                json.dumps(PROBE_LIMITS[driver, config]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Spec(root)


def driver_of(spec, name):
    return spec.traffic(spec.cell(name)["traffic"])["driver"]


def run(spec, name, trace=False, faults=()):
    d = driver_of(spec, name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return cells.run_cell(name, SEED, SECONDS[d], trace, spec=spec, device="cpu",
                              overrides=SMALL[d], faults=faults)


CELLS = [w["name"] for w in Spec().benchmark["workloads"]]
ALL = sorted(set(CELLS) | set(PROBES.values()))


@pytest.mark.parametrize("name", CELLS)
def test_benchmark_cell_runs_correct(name):
    r = run(Spec(), name)
    # gpbench/run.py prints these two on standard error
    keys = [k for k in r if k not in ("setup_marks", "window_notes")]
    assert keys[: len(KEYS)] == KEYS and keys[-1] == "compared"
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0
    spec = Spec()
    assert set(r["compared"]) == set(spec.limits(name))
    for c in r["compared"].values():
        assert set(c) == {"value", "limit"}
    assert set(r["metrics"]) == {m["name"] for m in spec.metrics_for(name, False)}
    for v in r["metrics"].values():
        assert v["value"] > 0 and v["unit"]
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("name", ALL)
def test_sound_run_is_correct(probe_spec, name):
    r = run(probe_spec, name)
    assert r["correct"], r["compared"]
    assert set(r["compared"]) == set(probe_spec.limits(name))


@pytest.mark.parametrize("name", ["kin40k-mixed-train", "kin40k-serve"])
def test_traced_run_line(probe_spec, name):
    r = run(probe_spec, name, trace=True)
    assert r["correct"], r["compared"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("name, fault", [(n, f) for n in ALL if "train" in n
                                         for f in ("frozen_state", "half_batch")]
                         + [(n, "altered_answer") for n in ALL if "serve" in n])
def test_broken_path_is_not_correct(probe_spec, name, fault):
    r = run(probe_spec, name, faults=(fault,))
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("name", ALL)
def test_control_separates(probe_spec, name):
    """The control reads at least three times the program on one number or
    more.  Its readings grow with n: at the cells' size they stand above
    the limits (PERF.md gives both readings of every limit)."""
    d = driver_of(probe_spec, name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ctx, outcome = cells.drive(probe_spec, name, SEED, SECONDS[d], False, device="cpu",
                                   overrides=SMALL[d])
        program = dict(outcome.judge())
        control = dict(outcome.control(CONTROL[ctx.config["precision"]]))
    assert any(control[k] >= 3 * program[k] and control[k] > 0 for k in control), \
        (program, control)

"""One run of one cell: set-up, the measured window, the metrics, the check.

A driver (``gpbench/harness/drivers/<traffic driver>.py``) sets the cell up
and drives its window through the :class:`Context`; it returns the window's
records and a ``judge`` that compares what the window produced with the
reference once the program's state is gone.  The order of a run:

1. set-up (data, model, warm-up) until ``Context.window_start``: ``setup_s``
   is the time from the process's start to there;
2. the window (profiled, with the program's metrics registry installed,
   when ``trace``);
3. the metrics, read from the records and the trace;
4. the card's peak memory, read before the reference runs;
5. ``judge``: every number compared, each against its limit.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable

import torch

from . import chip, profile
from .program import import_program
from .spec import Spec


@dataclasses.dataclass
class Context:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_proc: float
    #: test hooks that break the timed path underneath (gpbench/tests)
    faults: tuple = ()
    setup_s: float | None = None
    window: profile.Window = None
    span: Callable = None
    registry: object = None
    #: (what, seconds since the process started) through set-up
    marks: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.window = profile.Window(self.trace)
        self.span = profile.spans(self.trace)

    def mark(self, what: str) -> None:
        """A point of set-up, for the run's record on standard error."""
        chip.sync(self.device)
        self.marks.append((what, time.time() - self.t_proc))

    def window_start(self) -> float:
        """Close set-up and open the window; returns its start (perf_counter)."""
        self.mark("window")
        self.setup_s = self.marks[-1][1]
        if self.trace:
            from repro_torch import obs

            self.registry = obs.install()
        self.window.start()
        return time.perf_counter()

    def window_stop(self) -> float:
        chip.sync(self.device)
        t1 = time.perf_counter()
        self.window.stop()
        if self.registry is not None:
            from repro_torch import obs

            obs.uninstall()
        return t1


@dataclasses.dataclass
class Outcome:
    records: dict  # what the metric readers read: "window_s" and the driver's own
    attempted: int
    failed: int
    judge: Callable  # () -> [(name, value)]: the numbers compared
    #: (rounding) -> [(name, value)]: the same numbers with the reference at
    #: ``rounding`` in the program's place (the control; gpbench/calibrate.py)
    control: Callable = None
    #: (rounding) -> dict: the readings behind the numbers (gpbench/calibrate.py)
    detail: Callable = None


@dataclasses.dataclass
class Run:
    """What a metric reader gets."""

    cell: dict
    config: dict
    traffic: dict
    records: dict
    setup_s: float
    trace: profile.Trace | None
    registry: dict | None


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def drive(spec: Spec, name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
          t_proc: float | None = None, overrides: dict | None = None, faults: tuple = ()):
    """Set-up and window of cell ``name``: (context, outcome)."""
    overrides = overrides or {}
    cell = spec.cell(name)
    config = merge(spec.config(cell["config"]), overrides.get("config", {}))
    traffic = merge(spec.traffic(cell["traffic"]), overrides.get("traffic", {}))
    t_proc = chip.process_start() if t_proc is None else t_proc
    import_program()
    from repro_torch.core.health import SolveHealthWarning

    # a solve that stops at max_cg_iters warns every time; the runs print none
    warnings.filterwarnings("ignore", category=SolveHealthWarning)
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=int(seed),
                  seconds=float(seconds), trace=bool(trace), device=torch.device(device),
                  t_proc=t_proc, faults=tuple(faults))
    ctx.mark("program imported")
    return ctx, spec.driver(traffic["driver"]).run(ctx)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, spec: Spec | None = None,
             device="cuda", t_proc: float | None = None, overrides: dict | None = None,
             faults: tuple = ()) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``overrides`` ({"config": {...}, "traffic": {...}}) and ``faults`` are
    for the CPU tests."""
    spec = spec or Spec()
    limits = spec.limits(name)
    ctx, outcome = drive(spec, name, seed, seconds, trace, device=device, t_proc=t_proc,
                         overrides=overrides, faults=faults)
    run = Run(cell=ctx.cell, config=ctx.config, traffic=ctx.traffic, records=outcome.records,
              setup_s=ctx.setup_s, trace=ctx.window.trace,
              registry=ctx.registry.snapshot() if ctx.registry is not None else None)
    metrics = {}
    for m in spec.metrics_for(name, trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = chip.device_record(ctx.device, ctx.cell["chips"])
    breakdown = None
    if run.trace is not None:
        device_rec.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        breakdown = {"device_ops": run.trace.device_ops(), "idle_gaps": run.trace.idle_gaps()}
    setup_marks = ctx.marks
    del run, ctx
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    compared = [(k, float(v), limits.get(k)) for k, v in outcome.judge()]
    # every number the cell's limits name has to be there and within its limit
    missing = set(limits) - {k for k, _, _ in compared}
    correct = (outcome.failed == 0 and not missing
               and all(lim is not None and v == v and v <= lim for _, v, lim in compared))
    result = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    # printed on standard error by gpbench/run.py
    result["setup_marks"] = setup_marks
    result["window_notes"] = outcome.records.get("notes", {})
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
    return result

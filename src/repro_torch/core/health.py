"""Solve-health taxonomy: machine-checkable verdicts for every mBCG solve.

Counterpart of ``repro.core.health``.  :func:`classify_mbcg` turns the raw
:class:`~repro_torch.core.mbcg.MBCGResult` telemetry into one status of a
small closed taxonomy:

    CONVERGED   residual at or under tolerance, nothing pathological
    MAX_ITERS   ran out of budget while still making progress
    STALLED     the mixed-precision refresh loop's curvature guard tripped
                (``MBCGResult.num_curvature_skips``)
    RESCUED     its non-finite rescue fired (``MBCGResult.num_rescues``)
    NON_FINITE  the returned solution or residual itself is NaN/Inf
    DIVERGED    finite but the relative residual grew past the divergence gate

Classification reads a handful of scalars on the host after the solve (it
synchronises once; never inside the CG loop).  Reports reach interested
callers through a thread-local sink — :func:`collect` / :func:`record`,
which is also the one metrics seam for solve outcomes (:mod:`repro_torch.obs`).
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch

from repro_torch import obs

# --- taxonomy -------------------------------------------------------------

CONVERGED = "CONVERGED"
MAX_ITERS = "MAX_ITERS"
STALLED = "STALLED"
RESCUED = "RESCUED"
NON_FINITE = "NON_FINITE"
DIVERGED = "DIVERGED"

STATUSES = (CONVERGED, MAX_ITERS, STALLED, RESCUED, NON_FINITE, DIVERGED)

#: statuses that count as healthy for the degradation ladder.  RESCUED means
#: the rescue caught a transient non-finite and the final residual still
#: certifies the answer, so it is unhealthy only when it *also* failed to
#: converge — that combination classifies as RESCUED (res > tol) and is not
#: in this set.
HEALTHY = (CONVERGED,)

#: relative-residual threshold past which a finite solve is DIVERGED rather
#: than merely MAX_ITERS: the iterate is worse than the zero initial guess.
DIVERGENCE_GATE = 1.0


@dataclass(frozen=True)
class RungRecord:
    """One rung of the degradation ladder, as actually executed."""

    rung: str
    status: Optional[str]  # taxonomy status, or None if the rung errored
    residual_norm: Optional[float] = None
    num_iters: Optional[int] = None
    error: Optional[str] = None
    duration_s: Optional[float] = None  # wall time of this attempt (host-timed)


@dataclass(frozen=True)
class SolveReport:
    """Health verdict for one engine solve."""

    status: str
    residual_norm: float
    tol: float
    num_iters: int
    max_iters: int
    num_refreshes: int = 0
    num_rescues: int = 0
    num_curvature_skips: int = 0
    context: str = "solve"
    rungs: Tuple[RungRecord, ...] = ()

    @property
    def healthy(self) -> bool:
        return self.status in HEALTHY

    @property
    def degraded(self) -> bool:
        """True when the answer came from any rung past the initial solve."""
        return len(self.rungs) > 1

    @property
    def duration_s(self) -> Optional[float]:
        stamped = [r.duration_s for r in self.rungs if r.duration_s is not None]
        return sum(stamped) if stamped else None

    def describe(self) -> str:
        path = " -> ".join(
            f"{r.rung}:{r.status or 'error'}"
            + (f"({r.duration_s * 1e3:.1f}ms)" if r.duration_s is not None else "")
            for r in self.rungs
        )
        return (
            f"{self.context}: {self.status} "
            f"(res {self.residual_norm:.3e} vs tol {self.tol:.3e}, "
            f"{self.num_iters}/{self.max_iters} iters, "
            f"refreshes={self.num_refreshes} rescues={self.num_rescues} "
            f"curvature_skips={self.num_curvature_skips})"
            + (f" via [{path}]" if path else "")
        )


class SolveFailure(RuntimeError):
    """Raised when a solve is unhealthy and no ladder rung could heal it."""

    def __init__(self, message: str, report: Optional[SolveReport] = None):
        super().__init__(message)
        self.report = report


class SolveHealthWarning(UserWarning):
    """Emitted for unhealthy-but-served and degraded-but-healed solves."""


# --- classification -------------------------------------------------------


def _host_max(x) -> float:
    """max(x) as a host float — one scalar crosses to the host."""
    return float(torch.max(torch.as_tensor(x)))


def _host_int(x, default: int = 0) -> int:
    return default if x is None else int(_host_max(x))


def classify_mbcg(
    result, tol, *, max_iters: int, context: str = "solve", solution=None
) -> SolveReport:
    """Derive a SolveReport from an MBCGResult.

    ``tol`` is the tolerance actually in force.  Multi-column results
    classify by their WORST column: one poisoned probe column poisons
    everything downstream.  ``solution`` optionally overrides
    ``result.solves`` for the finiteness check."""
    res = _host_max(result.residual_norm)
    tol_f = _host_max(tol)
    iters = _host_int(result.num_iters)
    refreshes = _host_int(result.num_refreshes)
    rescues = _host_int(result.num_rescues)
    curv = _host_int(result.num_curvature_skips)

    sol = result.solves if solution is None else solution
    sol_finite = bool(torch.all(torch.isfinite(sol)))

    if not math.isfinite(res) or not sol_finite:
        status = NON_FINITE
    elif res <= tol_f:
        status = CONVERGED
    elif res > DIVERGENCE_GATE:
        status = DIVERGED
    elif rescues > 0:
        status = RESCUED
    elif curv > 0:
        status = STALLED
    else:
        status = MAX_ITERS

    report = SolveReport(
        status=status,
        residual_norm=res,
        tol=tol_f,
        num_iters=iters,
        max_iters=int(max_iters),
        num_refreshes=refreshes,
        num_rescues=rescues,
        num_curvature_skips=curv,
        context=context,
    )
    return replace(
        report,
        rungs=(RungRecord(rung="initial", status=status, residual_norm=res, num_iters=iters),),
    )


# --- thread-local report sink --------------------------------------------

_sink = threading.local()


@contextmanager
def collect(into: Optional[list] = None):
    """Collect every SolveReport record()ed on this thread into a list.
    Nested collectors stack: record() appends to the innermost one only."""
    reports: list = [] if into is None else into
    stack = getattr(_sink, "stack", None)
    if stack is None:
        stack = _sink.stack = []
    stack.append(reports)
    try:
        yield reports
    finally:
        stack.pop()


def record(report: Optional[SolveReport]) -> Optional[SolveReport]:
    """Deliver a report to the innermost collect() on this thread, if any.

    Also the single metrics seam for solve outcomes: every final report —
    and only final reports — passes through here, so the obs registry sees
    exactly one ``solves_total`` increment per engine solve with the full
    rung trail attached."""
    if report is None:
        return None
    if obs.active() is not None:
        _obs_emit(report)
    stack = getattr(_sink, "stack", None)
    if stack:
        stack[-1].append(report)
    return report


def _obs_emit(report: SolveReport) -> None:
    """Translate one SolveReport into registry updates (sink installed)."""
    obs.inc("solves_total", status=report.status, context=report.context)
    if report.degraded:
        obs.inc("solves_degraded_total", context=report.context)
    for r in report.rungs:
        obs.inc("ladder_rungs_total", rung=r.rung, status=r.status or "error")
        if r.duration_s is not None:
            obs.observe("ladder_rung_seconds", r.duration_s, rung=r.rung)
    dur = report.duration_s
    if dur is not None:
        obs.observe("solve_seconds", dur, context=report.context)

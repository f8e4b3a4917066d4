"""Per-solve trace spans → Chrome trace-event JSON (Perfetto-loadable);
counterpart of ``repro.obs.trace``.

A :func:`trace` context installs a process-wide :class:`TraceCollector`;
instrumented code opens nested :func:`span`s (solve → rung attempt → mbcg
→ panel launch) and drops :func:`instant` markers (a kernel launch, on the
GPU).  The collector writes the Trace Event Format's "X" (complete) and
"i" (instant) events with microsecond timestamps, so the file loads
directly in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``:

    with obs.trace("solve.trace.json"):
        solve(op, b, settings)

Nesting is positional, exactly as Chrome expects: spans on the same
thread whose [ts, ts+dur] intervals contain one another render as a
flame-graph stack.  Thread id = Python ``threading.get_ident()`` so the
serving session's worker threads get their own rows.  The spans time the
host: the kernels run asynchronously, so a span that does not read a
device value closes before its launches have finished.

Same null-sink discipline as the metrics registry: with no collector
installed, :func:`span` yields immediately and :func:`instant` is a
``None``-check.  No torch import at module scope — the optional profiler
pass-through (:func:`annotation`: a ``torch.profiler.record_function``
range, and an NVTX range on CUDA, for lining our spans up with the
kernels in a ``torch.profiler`` or Nsight capture) imports torch lazily
and only when enabled via :func:`enable_annotations` or
``REPRO_OBS_PROFILER_TRACE=1``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Optional


class TraceCollector:
    """Accumulates Chrome trace events (thread-safe appends)."""

    def __init__(self, *, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self.events: list = []

    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def add_complete(self, name: str, ts_us: float, dur_us: float, args=None):
        ev = {
            "name": name,
            "ph": "X",
            "ts": ts_us,
            "dur": max(dur_us, 0.0),
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def add_instant(self, name: str, args=None):
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "ts": self.now_us(),
            "pid": self._pid,
            "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self.events.append(ev)

    def spans(self, name: Optional[str] = None) -> list:
        """All complete ("X") events, optionally filtered by name."""
        with self._lock:
            evs = list(self.events)
        return [e for e in evs if e["ph"] == "X" and (name is None or e["name"] == name)]

    def instants(self, name: Optional[str] = None) -> list:
        with self._lock:
            evs = list(self.events)
        return [e for e in evs if e["ph"] == "i" and (name is None or e["name"] == name)]

    def to_dict(self) -> dict:
        with self._lock:
            return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


_active: Optional[TraceCollector] = None
_install_lock = threading.Lock()


def active_trace() -> Optional[TraceCollector]:
    """The installed collector, or None (the null-sink fast path)."""
    return _active


@contextmanager
def trace(path: Optional[str] = None, *, collector: Optional[TraceCollector] = None):
    """Install a trace collector for the dynamic extent of the block.

    Yields the collector; if ``path`` is given the Chrome trace JSON is
    written there on exit (even on error — a failed solve's trace is the
    one you want to look at)."""
    global _active
    col = collector if collector is not None else TraceCollector()
    with _install_lock:
        prev = _active
        _active = col
    try:
        yield col
    finally:
        with _install_lock:
            _active = prev
        if path is not None:
            col.save(path)


@contextmanager
def span(name: str, **args):
    """A named trace span covering the block; no-op when no trace() active."""
    col = _active
    if col is None:
        yield None
        return
    t0 = col.now_us()
    try:
        yield col
    finally:
        col.add_complete(name, t0, col.now_us() - t0, args or None)


def instant(name: str, **args) -> None:
    """A zero-duration trace marker; no-op when no trace() active."""
    col = _active
    if col is not None:
        col.add_instant(name, args or None)


# --- optional torch.profiler / NVTX pass-through ---------------------------

_annotations_enabled = os.environ.get("REPRO_OBS_PROFILER_TRACE", "") not in ("", "0")
_NULL = nullcontext()


def enable_annotations(enabled: bool = True) -> None:
    """Toggle the profiler ranges around the kernel launch sites.

    Off by default: the ranges matter only inside a ``torch.profiler`` or
    Nsight capture, and an NVTX push / pop per launch is not free."""
    global _annotations_enabled
    _annotations_enabled = enabled


def annotation(name: str):
    """A ``torch.profiler.record_function(name)`` range — plus
    ``torch.cuda.nvtx.range(name)`` when CUDA is initialised — while
    enabled; a shared null context otherwise."""
    if not _annotations_enabled:
        return _NULL
    return _profiler_range(name)


@contextmanager
def _profiler_range(name: str):
    import torch

    with torch.profiler.record_function(name):
        if torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield

"""Process-wide metrics registry: counters, gauges, log-bucketed histograms
(counterpart of ``repro.obs.registry``, the same code).

Where :mod:`repro_torch.core.health` classifies *one* solve, the registry
aggregates *every* instrumented event in the process into label-keyed
time series:

    solves_total{status="CONVERGED",context="cache_build"}    counter
    serving_query_seconds{...}                                histogram
    panel_rows                                                gauge

Design constraints, in order:

  1. **Null-sink discipline** — instrumentation seams are live in the hot
     paths (mbcg, the engine, the serving session, the panel accounting
     hook).  When no registry is installed the seam cost is one module
     attribute read and a ``None`` check; no objects are allocated, no
     device values are read, no locks are taken.
  2. **Dependency-free** — stdlib only, no torch: callers hand over *host*
     scalars, so the registry can never force a device synchronisation.
  3. **Thread-safe** — the serving session's query workers, the background
     refresher and the chaos drill all feed the same registry
     concurrently; every mutation runs under one registry lock.

Histograms use **fixed log-spaced buckets** (half-decades, 1e-6 … 1e3 by
default), so series from different runs are directly comparable.

Module-level helpers (:func:`inc`, :func:`observe`, :func:`set_gauge`)
write to the **installed** registry (:func:`install` / :func:`uninstall` /
the :func:`installed` context manager) and are no-ops otherwise — they are
the seam functions instrumented code calls.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

#: fixed log-spaced histogram bucket upper bounds (half-decade steps).
#: Shared by every histogram unless overridden at first observe() — fixed
#: edges are what makes cross-run and cross-metric comparison honest.
DEFAULT_BUCKETS: tuple = tuple(
    round(10.0 ** (e / 2.0), 10) for e in range(-12, 7)
)  # 1e-6, 3.16e-6, ..., 316.2, 1e3

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def _label_key(labels: dict) -> tuple:
    """Canonical, hashable identity of a label set."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """One named metric family: kind + help + per-label-set series."""

    __slots__ = ("name", "kind", "help", "buckets", "series")

    def __init__(self, name: str, kind: str, help: str = "", buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = tuple(buckets) if buckets is not None else None
        # counter/gauge: labelkey -> float
        # histogram:     labelkey -> [bucket_counts (len(buckets)+1), sum, n]
        self.series: dict = {}


class MetricsRegistry:
    """Thread-safe, label-keyed counters / gauges / histograms."""

    def __init__(self, *, buckets=DEFAULT_BUCKETS):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._default_buckets = tuple(buckets)

    # -- internals ----------------------------------------------------------
    def _get(self, name: str, kind: str, help: str, buckets=None) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = _Metric(
                name,
                kind,
                help,
                (buckets or self._default_buckets) if kind == HISTOGRAM else None,
            )
            self._metrics[name] = m
        elif m.kind != kind:
            raise ValueError(
                f"metric {name!r} is a {m.kind}, not a {kind} — one name, one kind"
            )
        if help and not m.help:
            m.help = help
        return m

    # -- writes -------------------------------------------------------------
    def inc(self, name: str, value: float = 1.0, *, help: str = "", **labels):
        """Add ``value`` (≥0) to the counter series ``name{labels}``."""
        if value < 0:
            raise ValueError(f"counter {name} cannot decrease (got {value})")
        key = _label_key(labels)
        with self._lock:
            m = self._get(name, COUNTER, help)
            m.series[key] = m.series.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, *, help: str = "", **labels):
        """Set the gauge series ``name{labels}`` to ``value``."""
        key = _label_key(labels)
        with self._lock:
            m = self._get(name, GAUGE, help)
            m.series[key] = float(value)

    def observe(
        self, name: str, value: float, *, help: str = "", buckets=None, **labels
    ):
        """Record ``value`` into the histogram series ``name{labels}``."""
        key = _label_key(labels)
        v = float(value)
        with self._lock:
            m = self._get(name, HISTOGRAM, help, buckets)
            s = m.series.get(key)
            if s is None:
                s = m.series[key] = [[0] * (len(m.buckets) + 1), 0.0, 0]
            counts, _, _ = s
            # cumulative-at-render; store per-bucket here (le-th bucket is
            # the first whose upper bound holds the value; last = +Inf)
            for i, edge in enumerate(m.buckets):
                if v <= edge:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            s[1] += v
            s[2] += 1

    # -- reads --------------------------------------------------------------
    def get(self, name: str, **labels) -> Optional[float]:
        """Current value of a counter/gauge series (None if absent)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m.kind == HISTOGRAM:
                return None
            return m.series.get(_label_key(labels))

    def get_histogram(self, name: str, **labels):
        """(bucket_edges, per-bucket counts, sum, count) or None."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m.kind != HISTOGRAM:
                return None
            s = m.series.get(_label_key(labels))
            if s is None:
                return None
            return m.buckets, tuple(s[0]), s[1], s[2]

    def sum(self, name: str) -> float:
        """Sum of a counter across ALL label sets (0.0 if absent)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m.kind != COUNTER:
                return 0.0
            return sum(m.series.values())

    def snapshot(self) -> dict:
        """Plain-dict copy: {name: {"kind", "help", "series": {labels: ...}}}.

        Histogram series appear as {"sum", "count", "buckets": {le: cum}}.
        """
        out: dict = {}
        with self._lock:
            for name, m in self._metrics.items():
                series: dict = {}
                for key, s in m.series.items():
                    label_s = ",".join(f"{k}={v}" for k, v in key)
                    if m.kind == HISTOGRAM:
                        counts, total, n = s
                        cum, acc = {}, 0
                        for edge, c in zip(m.buckets, counts):
                            acc += c
                            cum[edge] = acc
                        cum["+Inf"] = acc + counts[-1]
                        series[label_s] = {"sum": total, "count": n, "buckets": cum}
                    else:
                        series[label_s] = s
                out[name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    # -- exposition ---------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: list = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append(f"# HELP {name} {_escape_help(m.help)}")
                lines.append(f"# TYPE {name} {m.kind}")
                for key in sorted(m.series):
                    s = m.series[key]
                    if m.kind == HISTOGRAM:
                        counts, total, n = s
                        acc = 0
                        for edge, c in zip(m.buckets, counts):
                            acc += c
                            lines.append(
                                f"{name}_bucket{_fmt_labels(key, le=_fmt_float(edge))} {acc}"
                            )
                        lines.append(
                            f"{name}_bucket{_fmt_labels(key, le='+Inf')} "
                            f"{acc + counts[-1]}"
                        )
                        lines.append(f"{name}_sum{_fmt_labels(key)} {_fmt_float(total)}")
                        lines.append(f"{name}_count{_fmt_labels(key)} {n}")
                    else:
                        lines.append(f"{name}{_fmt_labels(key)} {_fmt_float(s)}")
        return "\n".join(lines) + "\n"


def _fmt_float(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: tuple, **extra) -> str:
    items = list(key) + [(k, v) for k, v in extra.items()]
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in items)
    return "{" + body + "}"


# --- the process-wide installed registry -----------------------------------
#
# ONE module-global, read directly by the seam helpers below: the whole
# disabled-path cost is `_active is None`.

_active: Optional[MetricsRegistry] = None
_install_lock = threading.Lock()


def install(registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Install ``registry`` (or a fresh one) as the process-wide sink.

    Idempotent-friendly: installing over an existing registry replaces it
    (the old one keeps its data; callers that want stacking semantics use
    the :func:`installed` context manager)."""
    global _active
    with _install_lock:
        _active = registry if registry is not None else MetricsRegistry()
        return _active


def uninstall() -> None:
    """Remove the installed registry — instrumentation becomes a no-op."""
    global _active
    with _install_lock:
        _active = None


def active() -> Optional[MetricsRegistry]:
    """The installed registry, or None (the null-sink fast path)."""
    return _active


@contextmanager
def installed(registry: Optional[MetricsRegistry] = None):
    """Scoped install: restores the previously installed registry on exit."""
    global _active
    with _install_lock:
        prev = _active
        reg = registry if registry is not None else MetricsRegistry()
        _active = reg
    try:
        yield reg
    finally:
        with _install_lock:
            _active = prev


# --- seam helpers (what instrumented code calls) ---------------------------


def inc(name: str, value: float = 1.0, **labels) -> None:
    r = _active
    if r is not None:
        r.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    r = _active
    if r is not None:
        r.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    r = _active
    if r is not None:
        r.observe(name, value, **labels)

"""repro_torch.obs — dependency-free telemetry for solver → engine → serving
(counterpart of ``repro.obs``).

Three pieces, one discipline:

* :mod:`.registry` — process-wide metrics registry (counters, gauges,
  fixed-log-bucket histograms; thread-safe, label-keyed).
* :mod:`.trace` — per-solve trace spans emitting Chrome trace-event JSON
  (Perfetto-loadable), plus optional ``torch.profiler`` / NVTX ranges at
  the kernel launch sites (:func:`annotation`).
* :mod:`.exposition` — Prometheus ``/metrics`` + ``/health`` JSON on a
  stdlib ``http.server`` daemon thread, and the text-format parser behind
  the ``gp_top`` CLI.

The discipline: every seam in the instrumented code is a no-op unless a
sink is installed (``install()`` for metrics, ``trace()`` for spans) —
the same null-sink rule as ``health.collect()``.  No seam reads a device
value, so none adds a host synchronisation, unless a registry is
installed.
"""

from .registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    MetricsRegistry,
    active,
    inc,
    install,
    installed,
    observe,
    set_gauge,
    uninstall,
)
from .trace import (  # noqa: F401
    TraceCollector,
    active_trace,
    annotation,
    enable_annotations,
    instant,
    span,
    trace,
)
from .exposition import MetricsServer, parse_prometheus  # noqa: F401

__all__ = [
    "DEFAULT_BUCKETS",
    "MetricsRegistry",
    "MetricsServer",
    "TraceCollector",
    "active",
    "active_trace",
    "annotation",
    "enable_annotations",
    "inc",
    "install",
    "installed",
    "instant",
    "observe",
    "parse_prometheus",
    "set_gauge",
    "span",
    "trace",
    "uninstall",
]

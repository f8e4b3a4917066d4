"""PosteriorSession — the versioned serving wrapper over a GP model
(counterpart of ``repro.serving.session``).

The session owns the serving triple (params, X, y) and a posterior cache
derived from it, and keeps the two consistent through an explicit
version/fingerprint discipline:

  * every live cache carries a :class:`CacheInfo` — a monotonically
    increasing version number, the SHA-1 **fingerprint** of the exact
    (params, X, y) it was derived from, and its *staleness* (incremental
    updates since the last full build);
  * every mutation goes through the session API (``observe`` appends data,
    ``update_params`` swaps hyperparameters), which re-fingerprints the
    state — a cache whose fingerprint no longer matches is rebuilt before
    the next query is answered.  ``update_params`` hashes the whole
    (params, X, y); ``observe`` chains the previous fingerprint with the
    appended rows' digest (:func:`chain_fingerprint`), so an append
    copies only its k rows to the host, never X;
  * ``observe(X_new, y_new)`` keeps the cache live *incrementally* when the
    model supports streaming (``update_cache``: warm-started CG with
    Krylov-basis recycling for ExactGP); once ``max_staleness``
    consecutive incremental updates have accumulated it falls back to a
    full rebuild;
  * ``stale()`` / ``rebuild()`` are the async-refresh hooks, and
    ``rebuild_async(executor)`` is the **double-buffered** variant: vN
    keeps serving while vN+1 builds on a worker, and the finished buffer
    swaps in only on fingerprint match (a mutation that landed mid-build
    discards it);
  * the request path is hardened: a per-session :class:`CircuitBreaker`
    over rebuilds, bounded retries with backoff, per-query admission
    deadlines, and degraded answers from the last consistent cache.

Queries are served entirely from the cache — no CG, no kernel launch.
Caches are built under ``torch.no_grad()`` (not ``inference_mode``: a cache
may meet autograd later).  Input finiteness is checked once per mutation
(one host synchronisation), never per query.

Threads: every thread launches on the device's current stream (PyTorch
gives each new thread the default stream), so one stream orders every
build, append and query on the device, and a swapped-in cache is complete
for every later query by stream order.  No side stream is used.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import health
from repro_torch.gp.model import missing_protocol_methods, supports_streaming


def _leaves(tree):
    """The array leaves of a nested tuple / list / dict in the reference's
    pytree order (dict values by sorted key; None holds no leaf)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key])
    elif isinstance(tree, (tuple, list)):
        for item in tree:
            yield from _leaves(item)
    else:
        yield tree


def fingerprint(tree) -> str:
    """SHA-1 content fingerprint of a nested structure of tensors / arrays.

    Hashes every leaf's shape, dtype and raw bytes, through
    ``.detach().cpu().numpy()`` for tensors — the reference's digest for the
    same arrays.  A host transfer: a mutation-time cost, never a query-time
    one."""
    h = hashlib.sha1()
    for leaf in _leaves(tree):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def chain_fingerprint(fp: str, appended) -> str:
    """Fingerprint of the state reached from the state ``fp`` by appending
    ``appended`` (the new rows): SHA-1 of ``fp`` and the rows' own digest.
    O(k·d) on the host for k rows, where re-hashing (params, X, y) would
    copy all of X."""
    return hashlib.sha1((fp + fingerprint(appended)).encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class CacheInfo:
    """Provenance of a live posterior cache."""

    version: int  # bumped on every cache swap (build or incremental)
    fingerprint: str  # of the (params, X, y) this cache serves
    n: int  # training rows covered
    staleness: int  # incremental updates since the last full build
    degraded: bool = False  # True while queries are answered from the last
    # CONSISTENT cache instead of a current one (the breaker is open, fresh
    # mutations not yet reflected); cleared by the next successful swap


class Served(NamedTuple):
    """The state one query was answered from: its cache's provenance and
    the (params, data, cache) triple itself (audit and replay)."""

    info: CacheInfo
    params: Any
    data: Any
    cache: Any


class QueryDeadlineExceeded(TimeoutError):
    """A query could not be admitted within its per-query deadline."""


class RebuildFailed(RuntimeError):
    """No cache could be (re)built and no consistent fallback exists."""


class CircuitBreaker:
    """Per-session circuit breaker over posterior-cache rebuilds.

    Three-state machine, deterministic via an injectable clock:

      * ``closed``    — rebuilds flow normally; failures count up;
      * ``open``      — ``threshold`` consecutive failures tripped it; no
        rebuild is attempted until ``reset_after_s`` has elapsed (queries
        serve the last consistent cache, flagged degraded);
      * ``half_open`` — the cool-down elapsed; ONE trial rebuild is
        admitted — success re-closes, failure re-opens.

    ``transitions`` records the most recent (from, to, t) edges in a ring
    buffer of ``transition_history`` entries; ``transitions_total`` counts
    every edge (also the ``breaker_transitions_total`` registry counter).
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, threshold: int = 3, reset_after_s: float = 30.0, *,
                 clock=time.monotonic, transition_history: int = 64):
        self.threshold = int(threshold)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.failures = 0
        self._opened_at: float | None = None
        self.transitions: deque = deque(maxlen=int(transition_history))
        self.transitions_total = 0

    def _set(self, state: str) -> None:
        if state != self.state:
            self.transitions.append((self.state, state, self._clock()))
            self.transitions_total += 1
            obs.inc("breaker_transitions_total", **{"from": self.state, "to": state})
            self.state = state

    def allow(self) -> bool:
        """May a rebuild be attempted right now?"""
        with self._lock:
            if self.state == self.OPEN:
                if self._clock() - self._opened_at >= self.reset_after_s:
                    self._set(self.HALF_OPEN)
                    return True
                return False
            return True  # closed, or half-open trial

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._set(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self.state == self.HALF_OPEN or self.failures >= self.threshold:
                self._set(self.OPEN)
                self._opened_at = self._clock()


def _require_finite(name: str, x: torch.Tensor) -> None:
    bad = int((~torch.isfinite(x)).sum())  # one host synchronisation
    if bad:
        raise ValueError(
            f"{name} contains {bad} non-finite value(s) (NaN/Inf) out of "
            f"{x.numel()}; clean the rows (e.g. drop or impute them) before "
            "conditioning a posterior on them — a single non-finite entry "
            "poisons every solve"
        )


class PosteriorSession:
    """Versioned, streaming-updatable posterior serving for one GP model.

    Args:
      model: a GP model (:class:`repro_torch.gp.model.GPModel`); its
        ``device`` (if any) is where the session keeps X and y.
      params: fitted hyperparameters.
      X, y: training data the posterior conditions on (arrays or tensors).
      max_staleness: consecutive incremental ``observe`` updates allowed
        before the next one forces a full rebuild (0 → every observe
        rebuilds).  For the Krylov cache it also bounds basis growth (≤
        max_cg_iters+1 columns per update); ``settings.max_basis_columns``
        bounds it in memory instead (Rayleigh–Ritz compaction).
      build: build the cache eagerly (default) or lazily on first query.
      query_deadline_s: per-query admission deadline — a query that cannot
        obtain a servable cache within it serves the last consistent cache
        degraded, or raises :class:`QueryDeadlineExceeded` if none exists.
        None waits indefinitely.  It governs admission, not the compute.
      rebuild_retries / rebuild_backoff_s: failed rebuilds are retried up
        to ``rebuild_retries`` more times, ``rebuild_backoff_s``·2^attempt
        apart, before counting as a rebuild failure.
      breaker_threshold / breaker_reset_s: the :class:`CircuitBreaker`'s
        consecutive-failure threshold and cool-down.
      clock / sleep: injectable time sources (deterministic tests).
    """

    def __init__(
        self,
        model,
        params,
        X,
        y,
        *,
        max_staleness: int = 8,
        build: bool = True,
        query_deadline_s: float | None = None,
        rebuild_retries: int = 2,
        rebuild_backoff_s: float = 0.05,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 30.0,
        clock=time.monotonic,
        sleep=time.sleep,
    ):
        missing = missing_protocol_methods(model)
        if missing:
            raise TypeError(
                f"{type(model).__name__} does not implement the GPModel "
                f"protocol (missing: {missing})"
            )
        self.model = model
        self.max_staleness = int(max_staleness)
        self.query_deadline_s = query_deadline_s
        self.rebuild_retries = int(rebuild_retries)
        self.rebuild_backoff_s = float(rebuild_backoff_s)
        self._clock = clock
        self._sleep = sleep
        self.breaker = CircuitBreaker(breaker_threshold, breaker_reset_s, clock=clock)
        # solve-health reports from builds / updates (bounded), and the
        # serving-degradation counters the chaos drill asserts on
        self.health_reports: deque = deque(maxlen=256)
        self.degraded_queries = 0
        self.rebuild_failures = 0
        self._lock = threading.RLock()
        # single-flight gate for lazy rebuilds: N query workers hitting a
        # stale cache run ONE build, the rest wait for the swap
        self._rebuild_gate = threading.Lock()
        # the last internally consistent state, what queries serve while an
        # incremental append is in flight or the breaker is open
        self._serving: Served | None = None
        self._appends_in_flight = 0
        self._params = params
        self._X = torch.atleast_2d(self._as_tensor(X))
        self._y = torch.atleast_1d(self._as_tensor(y))
        _require_finite("X", self._X)
        _require_finite("y", self._y)
        self._data = model.prepare_inputs(self._X)
        self._state_fp = fingerprint((self._params, self._X, self._y))
        self._cache = None
        self._info: CacheInfo | None = None
        self._version = 0
        if build:
            self.rebuild()

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=getattr(self.model, "device", None))

    # -- state accessors ----------------------------------------------------
    @property
    def params(self):
        return self._params

    @property
    def X(self):
        return self._X

    @property
    def y(self):
        return self._y

    @property
    def n(self) -> int:
        return int(self._y.shape[0])

    @property
    def cache(self):
        """The live posterior cache (None before the first build)."""
        return self._cache

    @property
    def cache_info(self) -> CacheInfo | None:
        """Provenance of the live cache (None before the first build)."""
        return self._info

    @property
    def streaming(self) -> bool:
        return supports_streaming(self.model) and self.max_staleness > 0

    # -- versioning / refresh hooks ----------------------------------------
    def stale(self) -> bool:
        """True when the live cache no longer matches (params, X, y).  A
        successfully streamed cache is re-stamped and NOT stale; its
        ``cache_info.staleness`` counts the updates since a full build."""
        with self._lock:
            return self._cache is None or self._info.fingerprint != self._state_fp

    def _swap(self, params, data, cache, info: CacheInfo) -> CacheInfo:
        """Install a cache (caller holds the lock)."""
        self._version = info.version
        self._cache = cache
        self._info = info
        self._serving = Served(info, params, data, cache)
        return info

    def _build_and_swap(self, params, data, y, fp) -> CacheInfo | None:
        """Build a cache for the snapshotted state and swap it in — only
        while the fingerprint still matches (or nothing is live yet).
        Returns the swapped CacheInfo, or None when the buffer was
        discarded."""
        with health.collect() as reports, obs.span("serving:cache_build"), torch.no_grad():
            cache = self.model.posterior_cache(params, data, y)
        with self._lock:
            self.health_reports.extend(reports)
            if self._state_fp != fp and self._cache is not None:
                obs.inc("cache_swap_discards_total", kind="build")
                return None  # the state moved on mid-build: discard the buffer
            obs.inc("cache_swaps_total", kind="build")
            return self._swap(params, data, cache, CacheInfo(
                version=self._version + 1, fingerprint=fp, n=int(y.shape[0]), staleness=0))

    def rebuild(self) -> CacheInfo:
        """Full posterior-cache build from the current (params, X, y).

        Can run on a background worker (it reads serving state only until
        the final swap) while queries are served from the previous cache.
        The swap is fingerprint-gated: if a mutation landed mid-build, the
        stale buffer is discarded and the live (newer) info returned."""
        with self._lock:
            params, data, y, fp = self._params, self._data, self._y, self._state_fp
        info = self._build_and_swap(params, data, y, fp)
        if info is not None:
            return info
        with self._lock:
            return self._info

    def _rebuild_guarded(self) -> CacheInfo | None:
        """``rebuild`` with bounded exponential-backoff retry and breaker
        accounting: the request-path (and observe-path) rebuild.  Raises
        the final attempt's error after recording a rebuild failure."""
        last_err = None
        for attempt in range(1 + self.rebuild_retries):
            if attempt:
                self._sleep(self.rebuild_backoff_s * (2 ** (attempt - 1)))
            try:
                info = self.rebuild()
            except Exception as e:  # noqa: BLE001 — any build fault degrades
                last_err = e
                continue
            self.breaker.record_success()
            return info
        self.breaker.record_failure()
        with self._lock:
            self.rebuild_failures += 1
        obs.inc("rebuild_failures_total")
        raise last_err

    def refresh_if_stale(self) -> bool:
        """Poll-style hook for a background refresher: rebuild when the
        cache is invalid OR has accumulated incremental updates."""
        with self._lock:
            needs = self.stale() or (self._info is not None and self._info.staleness > 0)
        if needs:
            self.rebuild()
        return needs

    def rebuild_async(self, executor=None):
        """Double-buffered refresh: build vN+1 on a worker while vN serves.

        Snapshots the state under the lock, builds off the request path,
        then swaps in **only if the fingerprint still matches**; a mutation
        that landed mid-build discards the buffer (result None).
        ``executor``: a ``concurrent.futures.Executor`` (returns a Future
        of the swapped :class:`CacheInfo` or None); None builds inline."""
        with self._lock:
            params, data, y, fp = self._params, self._data, self._y, self._state_fp

        def _build():
            return self._build_and_swap(params, data, y, fp)

        if executor is None:
            return _build()
        return executor.submit(_build)

    # -- mutations ----------------------------------------------------------
    def update_params(self, params) -> None:
        """Swap hyperparameters.  Invalidates the cache (fingerprint
        mismatch); the rebuild happens on the next query or ``rebuild()``."""
        with self._lock:
            self._params = params
            self._state_fp = fingerprint((self._params, self._X, self._y))

    def observe(self, X_new, y_new) -> str:
        """Append observations (X_new, y_new) to the posterior.

        Returns the path taken: ``"append"`` (incremental cache update) or
        ``"rebuild"`` (full build: non-streaming model, no valid cache, or
        the ``max_staleness`` budget exhausted).  The appended state is
        derived and validated before it is installed; the incremental
        update runs **off the session lock**, so concurrent queries keep
        serving the previous cache, and swaps in fingerprint-gated."""
        if obs.active() is None and obs.active_trace() is None:
            return self._observe_impl(X_new, y_new)
        t0 = time.perf_counter()
        with obs.span("serving:observe"):
            try:
                path = self._observe_impl(X_new, y_new)
            except Exception:
                obs.inc("serving_observes_total", path="error")
                raise
        obs.inc("serving_observes_total", path=path)
        obs.observe("serving_observe_seconds", time.perf_counter() - t0, path=path)
        return path

    def _observe_impl(self, X_new, y_new) -> str:
        X_new = torch.atleast_2d(self._as_tensor(X_new))
        y_new = torch.atleast_1d(self._as_tensor(y_new))
        if X_new.shape[0] != y_new.shape[0]:
            raise ValueError(f"X_new rows ({X_new.shape[0]}) != y_new length ({y_new.shape[0]})")
        # reject non-finite appends BEFORE any mutation
        _require_finite("X_new", X_new)
        _require_finite("y_new", y_new)
        with self._lock:
            X_full = torch.cat([self._X, X_new], dim=0)
            y_full = torch.cat([self._y, y_new], dim=0)
            # derive / validate BEFORE mutating
            data = self.model.prepare_inputs(X_full)
            can_stream = (
                self.streaming
                and self._cache is not None
                and self._info.fingerprint == self._state_fp
                and self._info.staleness < self.max_staleness
            )
            params, cache = self._params, self._cache
            staleness = self._info.staleness if self._info is not None else 0
            self._X, self._y, self._data = X_full, y_full, data
            fp = chain_fingerprint(self._state_fp, (X_new, y_new))
            self._state_fp = fp
            if can_stream:
                v0 = self._version
                self._appends_in_flight += 1
        if not can_stream:
            self._rebuild_guarded()
            return "rebuild"
        try:
            try:
                with health.collect() as reports, torch.no_grad():
                    new_cache = self.model.update_cache(params, data, y_full, cache, X_new, y_new)
            except Exception:
                # the data IS installed but the cache is now stale — the
                # next query rebuilds; count it with the breaker
                self.breaker.record_failure()
                with self._lock:
                    self.rebuild_failures += 1
                obs.inc("rebuild_failures_total")
                raise
            with self._lock:
                self.health_reports.extend(reports)
                # discard if another mutation landed or another build
                # already swapped in: never clobber a fresher cache
                if self._state_fp == fp and self._version == v0:
                    self._swap(params, data, new_cache, CacheInfo(
                        version=self._version + 1, fingerprint=fp, n=int(y_full.shape[0]),
                        staleness=staleness + 1))
                    obs.inc("cache_swaps_total", kind="append")
                else:
                    obs.inc("cache_swap_discards_total", kind="append")
        finally:
            with self._lock:
                self._appends_in_flight -= 1
        return "append"

    # -- queries ------------------------------------------------------------
    def _snapshot_consistent(self) -> Served | None:
        """The state a query may serve non-degraded, or None when a
        rebuild is needed first."""
        with self._lock:
            if self._cache is not None and self._info.fingerprint == self._state_fp:
                return Served(self._info, self._params, self._data, self._cache)
            # an incremental append is computing off-lock: serve the
            # PREVIOUS consistent state instead of stalling or duplicating
            if self._appends_in_flight > 0 and self._serving is not None:
                return self._serving
            return None

    def _serve_degraded(self) -> Served | None:
        """The last consistent state for a degraded answer (None if nothing
        was ever consistent), flagging ``cache_info``."""
        with self._lock:
            if self._serving is None:
                return None
            self.degraded_queries += 1
            obs.inc("serving_degraded_total")
            if self._info is not None and not self._info.degraded:
                self._info = dataclasses.replace(self._info, degraded=True)
            return self._serving

    def query(self, Xstar, **kwargs):
        """Posterior (mean, variance) at Xstar, served from the cache — no
        CG.  Rebuilds first if the cache is stale, single-flight under
        concurrency (one worker builds with retry / backoff, the rest wait
        for the swap).  While the breaker is open, or a guarded rebuild
        just exhausted its retries, the answer comes from the LAST
        CONSISTENT state with ``cache_info.degraded=True``;
        :class:`RebuildFailed` only when no consistent cache ever existed,
        :class:`QueryDeadlineExceeded` when nothing was servable within
        ``query_deadline_s``."""
        return self.query_served(Xstar, **kwargs)[0]

    def query_served(self, Xstar, **kwargs):
        """:meth:`query`, returning ``(answer, Served)``: the answer and
        the state it came from, for audit and replay."""
        if obs.active() is None and obs.active_trace() is None:
            return self._query_impl(Xstar, **kwargs)
        t0 = time.perf_counter()
        d0 = self.degraded_queries
        with obs.span("serving:query"):
            try:
                out = self._query_impl(Xstar, **kwargs)
            except Exception:
                obs.inc("serving_queries_total", result="error")
                raise
        # per-call degradation from the counter delta: exact single-threaded;
        # under contention a neighbour's degraded serve can only OVER-count
        result = "degraded" if self.degraded_queries > d0 else "ok"
        obs.inc("serving_queries_total", result=result)
        obs.observe("serving_query_seconds", time.perf_counter() - t0, result=result)
        return out

    def _query_impl(self, Xstar, **kwargs):
        deadline = None if self.query_deadline_s is None else self._clock() + self.query_deadline_s
        while True:
            served = self._snapshot_consistent()
            if served is not None:
                break
            # a rebuild is needed: breaker-gated, deadline-bounded
            if not self.breaker.allow():
                served = self._serve_degraded()
                if served is not None:
                    break
                raise RebuildFailed(
                    "circuit breaker is open and no consistent cache was ever "
                    "built for this session"
                )
            if deadline is not None:
                remaining = deadline - self._clock()
                acquired = remaining > 0 and self._rebuild_gate.acquire(timeout=remaining)
                if not acquired:
                    served = self._serve_degraded()
                    if served is not None:
                        break
                    raise QueryDeadlineExceeded(
                        f"query could not be admitted within {self.query_deadline_s}s "
                        "(rebuild in flight)"
                    )
            else:
                self._rebuild_gate.acquire()
            try:
                if self.stale():  # may have been rebuilt while we waited
                    try:
                        self._rebuild_guarded()
                    except Exception as e:
                        served = self._serve_degraded()
                        if served is not None:
                            break
                        raise RebuildFailed(
                            "posterior cache rebuild failed and no consistent "
                            "cache exists to degrade to"
                        ) from e
            finally:
                self._rebuild_gate.release()
        out = self.model.predict_cached(served.params, served.data, served.cache, Xstar, **kwargs)
        return out, served

    def health_stats(self) -> dict:
        """Operational counters + solve-health tallies for dashboards and
        tests; ``gp_serve --metrics-port`` serves it as ``/health`` JSON.
        With a registry installed its serving-relevant families ride along
        under ``"registry"``."""
        with self._lock:
            by_status: dict = {}
            for r in self.health_reports:
                by_status[r.status] = by_status.get(r.status, 0) + 1
            stats = {
                "breaker_state": self.breaker.state,
                "breaker_failures": self.breaker.failures,
                "breaker_transitions": list(self.breaker.transitions),
                "breaker_transitions_total": self.breaker.transitions_total,
                "degraded_queries": self.degraded_queries,
                "rebuild_failures": self.rebuild_failures,
                "reports_by_status": by_status,
                "degraded_rungs": sum(1 for r in self.health_reports if r.degraded),
            }
        reg = obs.active()
        if reg is not None:
            snap = reg.snapshot()
            stats["registry"] = {
                name: fam
                for name, fam in snap.items()
                if name.startswith(("serving_", "cache_", "breaker_", "solves_"))
            }
        return stats

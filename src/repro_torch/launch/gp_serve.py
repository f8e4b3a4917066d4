"""GP serving driver: batched posterior queries + interleaved streaming
observations through a :class:`repro_torch.serving.PosteriorSession`
(counterpart of ``repro.launch.gp_serve``).

    PYTHONPATH=src python -m repro_torch.launch.gp_serve --model sgpr \
        --n 2000 --requests 40 --batch 256 --observe-every 8

A request loop answers batched mean / variance queries entirely from the
posterior cache (no CG per request), periodically interrupted by new
observations folded in *incrementally* — an exact rank-k Woodbury refresh
with zero CG for SGPR and BLR, warm-started CG with Krylov-basis recycling
for ExactGP, DKL and the multitask GP — under the session's
``max_staleness`` policy.  Reports cached query points per second and the
append-vs-rebuild latency split.

``--model`` (default ``sgpr``, as the reference's driver): ``exact`` is
``ExactGP(mode="cuda", kernel_type="rbf")`` and ``multitask`` is
``MultitaskGP(mode="cuda")`` over ``--num-tasks`` tasks (long-format rows;
appends are complete task blocks): on the GPU every data-kernel K·M is a
launch of the kernel-matrix kernel (B1, or its bf16 mode under
``--precision mixed``).  ``sgpr``, ``blr`` (low-rank roots) and ``dkl`` (a
deep kernel, dense mode) run plain PyTorch contractions and launch no
kernel.  ``--device cpu`` runs every model on the plain versions.
``ski`` is ROADMAP Queue A step 15b and raises.

``--threads N`` switches to the **thread-pool request driver**: N worker
threads issue query batches concurrently while the main thread streams
observations and kicks double-buffered refreshes (``rebuild_async``) onto a
refresher worker; buffers that a mid-build mutation made stale are
discarded instead of swapped (counted in the report).

``--chaos`` runs the **fault-injection drill** over the threaded driver: a
seeded :class:`repro_torch.core.FaultSchedule` corrupts the kernel matmuls
mid-serve (NaN in the bf16 path, then a total outage) while query workers
keep hammering the session.  It exits nonzero unless the ladder's
``precision_f32`` escalation healed the bf16 NaNs, the breaker opened
under the outage while queries degraded to the last consistent cache
instead of erroring, and the breaker re-closed on recovery.

``--metrics-port`` serves Prometheus ``/metrics`` and ``/health`` JSON for
the run (``repro_torch.launch.gp_top`` renders them).

Data: ``--seed`` seeds numpy generators — the training set, each query
batch and each observation from one of their own — with the reference's
toy recipe, y = sin(3x₀)·cos(2x_{d−1}) + 0.05ε on X ~ U(−1, 1)^d.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import (
    AddedDiagOperator,
    BBMMSettings,
    FaultInjectingOperator,
    FaultSchedule,
    build_posterior_cache,
    extend_posterior_cache,
)
from repro_torch.core.health import CONVERGED, SolveHealthWarning
from repro_torch.gp import (
    SGPR,
    BayesianLinearRegression,
    DKLExactGP,
    ExactGP,
    MultitaskGP,
    to_long_format,
)
from repro_torch.serving import CircuitBreaker, PosteriorSession

MODELS = ("exact", "sgpr", "ski", "dkl", "blr", "multitask")


def build_model(
    name: str,
    *,
    max_cg_iters: int = 25,
    precision: str | None = None,
    max_basis_columns: int = 0,
    num_tasks: int = 2,
    device=None,
):
    """The driver's models, at the reference driver's settings: ``exact``
    is ``ExactGP(mode="cuda", kernel_type="rbf")`` at 8 probes and the
    engine's default rank-5 preconditioner, ``multitask``
    ``MultitaskGP(mode="cuda")`` at rank 0; ``sgpr`` has 64 inducing points
    and ``dkl`` a (16, 2) network."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r} ({'|'.join(MODELS)})")
    settings = BBMMSettings(num_probes=8, max_cg_iters=max_cg_iters,
                            max_basis_columns=max_basis_columns)
    if name == "exact":
        return ExactGP(mode="cuda", kernel_type="rbf", settings=settings, precision=precision,
                       device=device)
    if name == "sgpr":
        return SGPR(num_inducing=64, precision=precision, device=device)
    if name == "dkl":
        return DKLExactGP(hidden=(16, 2), settings=settings, precision=precision, device=device)
    if name == "blr":
        return BayesianLinearRegression(precision=precision, device=device)
    if name == "multitask":
        # task-kernel preconditioning is not implemented: rank 0
        return MultitaskGP(num_tasks=num_tasks, mode="cuda",
                           settings=dataclasses.replace(settings, precond_rank=0),
                           precision=precision, device=device)
    raise NotImplementedError(
        f"--model {name} is not ported yet: ROADMAP Queue A step 15b (SKI and its "
        "structured operators)"
    )


def _targets(rng, X):
    return np.sin(3 * X[:, 0]) * np.cos(2 * X[:, -1]) + 0.05 * rng.standard_normal(X.shape[0])


def _task_targets(rng, coords, T):
    """Per-task targets (n, T): one shared latent signal, a task-specific
    scale."""
    latent = np.sin(3 * coords[:, 0]) * np.cos(2 * coords[:, -1])
    scales = 1.0 + 0.3 * np.arange(T)
    return latent[:, None] * scales[None, :] + 0.05 * rng.standard_normal((coords.shape[0], T))


def _rows(rng, X, num_tasks):
    """(X, y) float32 for locations X: long-format rows, every location
    crossed with each task, when ``num_tasks`` > 0."""
    if num_tasks:
        return to_long_format(X, _task_targets(rng, X, num_tasks))
    return X, _targets(rng, X).astype(np.float32)


def _toy(seed, n, d, num_tasks=0):
    """(X, y) training data, float32 — n locations (n·T long-format rows
    for ``num_tasks`` > 0)."""
    rng = np.random.default_rng([seed, 0])
    return _rows(rng, rng.uniform(-1, 1, (n, d)).astype(np.float32), num_tasks)


def _query_batch(seed, r, batch, d, num_tasks=0):
    """Query batch r (its own generator: any thread can draw it); with
    ``num_tasks`` > 0, long-format rows with a random task each."""
    rng = np.random.default_rng([seed, 1, r])
    coords = rng.uniform(-1, 1, (batch, d)).astype(np.float32)
    if num_tasks:
        return to_long_format(coords, task_ids=rng.integers(0, num_tasks, batch),
                              num_tasks=num_tasks)
    return coords


def _observation(seed, r, k, d, num_tasks=0):
    """k new observations after request r — for multitask a complete task
    block per location (the append that keeps the Kronecker structure)."""
    rng = np.random.default_rng([seed, 2, r])
    return _rows(rng, rng.uniform(-1, 1, (k, d)).astype(np.float32), num_tasks)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _prepare(model, n, d, seed, fit_steps, **model_kw):
    T = model_kw["num_tasks"] if model == "multitask" else 0
    X, y = _toy(seed, n, d, T)
    gp = build_model(model, **model_kw)
    params = gp.fit(X, y, steps=fit_steps)[0] if fit_steps > 0 else gp.init_params(X)
    return gp, params, X, y


def _results(futures, timeout_s):
    """Every future's result, within ``timeout_s`` seconds in all (None:
    no limit); a TimeoutError names how many were still running."""
    done, pending = wait(futures, timeout=timeout_s)
    if pending:
        for f in pending:
            f.cancel()
        raise TimeoutError(f"{len(pending)} of {len(futures)} calls still running after "
                           f"{timeout_s} s")
    return [f.result() for f in futures]


def run_serve(
    *,
    model: str = "sgpr",
    n: int = 1000,
    d: int = 2,
    requests: int = 20,
    batch: int = 128,
    observe_every: int = 5,
    observe_batch: int = 1,
    max_staleness: int = 8,
    fit_steps: int = 0,
    max_cg_iters: int = 25,
    precision: str | None = None,
    max_basis_columns: int = 0,
    num_tasks: int = 2,
    seed: int = 0,
    device=None,
    verbose: bool = True,
    session_hook=None,
    observe_hook=None,
) -> dict:
    """Drive the request loop; return the metric row (also printed).

    ``session_hook(session)`` fires once the session exists (the metrics
    endpoint wires ``/health`` to it); ``observe_hook(session, r, path,
    seconds)`` after each observe, once its cache is ready.  ``n`` counts
    locations: the multitask model serves n·num_tasks rows."""
    T = num_tasks if model == "multitask" else 0
    gp, params, X, y = _prepare(model, n, d, seed, fit_steps, max_cg_iters=max_cg_iters,
                                precision=precision, max_basis_columns=max_basis_columns,
                                num_tasks=num_tasks, device=device)
    dev = gp.device

    t0 = time.perf_counter()
    session = PosteriorSession(gp, params, X, y, max_staleness=max_staleness)
    _sync(dev)
    t_build = time.perf_counter() - t0
    if session_hook is not None:
        session_hook(session)

    # warm the query path before timing
    session.query(_query_batch(seed, requests + 1, batch, d, T))
    _sync(dev)

    q_time = 0.0
    appends, rebuilds = [], []
    for r in range(requests):
        Xq = _query_batch(seed, r, batch, d, T)
        t0 = time.perf_counter()
        session.query(Xq)
        _sync(dev)
        q_time += time.perf_counter() - t0
        if observe_every and (r + 1) % observe_every == 0:
            Xn, yn = _observation(seed, r, observe_batch, d, T)
            t0 = time.perf_counter()
            path = session.observe(Xn, yn)
            _sync(dev)  # the UPDATED CACHE is in the measurement
            dt = time.perf_counter() - t0
            (appends if path == "append" else rebuilds).append(dt)
            if observe_hook is not None:
                observe_hook(session, r, path, dt)

    # the rebuild baseline the append path is measured against
    t0 = time.perf_counter()
    session.rebuild()
    _sync(dev)
    t_rebuild = time.perf_counter() - t0

    qps = requests * batch / q_time if q_time > 0 else float("inf")
    # steady-state append latency: the first append pays one-off warm-up,
    # so the minimum is the serving-relevant number; the mean too
    append_s = min(appends) if appends else float("nan")
    append_avg_s = sum(appends) / len(appends) if appends else float("nan")
    metrics = {
        "model": f"serve_{model}",
        "n": n,
        "batch": batch,
        "requests": requests,
        "cache_build_s": t_build,
        "cached_qps": qps,
        "query_ms": q_time / requests * 1e3,
        "append_s": append_s,
        "append_avg_s": append_avg_s,
        "rebuild_s": t_rebuild,
        "append_speedup": (t_rebuild / append_s) if appends else float("nan"),
        "num_appends": len(appends),
        "num_rebuilds": len(rebuilds),
        "observe_rebuild_s": rebuilds,
        "final_n": session.n,
        "cache_version": session.cache_info.version,
    }
    if verbose:
        print(
            f"[{model}] n={n}→{session.n}  build {t_build*1e3:.0f} ms | "
            f"{requests} x {batch}-pt queries: {qps:,.0f} pts/s "
            f"({metrics['query_ms']:.1f} ms/req, CG-free) | "
            f"observe: {len(appends)} appends "
            f"{append_s*1e3 if appends else float('nan'):.1f} ms vs rebuild "
            f"{t_rebuild*1e3:.1f} ms "
            f"({metrics['append_speedup']:.1f}x) | {len(rebuilds)} rebuilds"
        )
    return metrics


def run_serve_threaded(
    *,
    model: str = "sgpr",
    n: int = 1000,
    d: int = 2,
    requests: int = 40,
    batch: int = 128,
    observe_every: int = 8,
    observe_batch: int = 1,
    max_staleness: int = 8,
    fit_steps: int = 0,
    max_cg_iters: int = 25,
    precision: str | None = None,
    max_basis_columns: int = 0,
    num_tasks: int = 2,
    threads: int = 4,
    seed: int = 0,
    device=None,
    verbose: bool = True,
    session_hook=None,
    query_hook=None,
    timeout_s: float | None = None,
) -> dict:
    """Concurrent request driver over the double-buffered session.

    ``threads`` query workers hammer ``session.query`` while the main
    thread streams observations and schedules ``rebuild_async`` refreshes
    on a dedicated worker — serving never blocks on a rebuild.
    ``query_hook(r, Xq, answer, served)`` sees each answer with the state
    it came from (:class:`repro_torch.serving.Served`).  ``timeout_s``
    bounds the wait for every query and refresh (TimeoutError past it)."""
    T = num_tasks if model == "multitask" else 0
    gp, params, X, y = _prepare(model, n, d, seed, fit_steps, max_cg_iters=max_cg_iters,
                                precision=precision, max_basis_columns=max_basis_columns,
                                num_tasks=num_tasks, device=device)
    dev = gp.device
    session = PosteriorSession(gp, params, X, y, max_staleness=max_staleness)
    if session_hook is not None:
        session_hook(session)

    # warm the query path before opening the floodgates
    session.query(_query_batch(seed, requests + 1, batch, d, T))
    _sync(dev)

    latencies = []
    lat_lock = threading.Lock()

    def one_query(r):
        Xq = _query_batch(seed, r, batch, d, T)
        t0 = time.perf_counter()
        answer, served = session.query_served(Xq)
        _sync(dev)
        dt = time.perf_counter() - t0
        with lat_lock:
            latencies.append(dt)
        if query_hook is not None:
            query_hook(r, Xq, answer, served)

    refresh_futures = []
    query_futures = []
    pool = ThreadPoolExecutor(max_workers=threads)
    refresher = ThreadPoolExecutor(max_workers=1)
    t_start = time.perf_counter()
    try:
        for r in range(requests):
            query_futures.append(pool.submit(one_query, r))
            if observe_every and (r + 1) % observe_every == 0:
                Xn, yn = _observation(seed, r, observe_batch, d, T)
                path = session.observe(Xn, yn)
                # a double-buffered refresh off the request path, only after
                # an incremental append (a rebuild left the cache fresh)
                if path == "append":
                    refresh_futures.append(session.rebuild_async(refresher))
        _results(query_futures, timeout_s)
        wall = time.perf_counter() - t_start
        swaps = _results(refresh_futures, timeout_s)
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
        refresher.shutdown(wait=False, cancel_futures=True)
    swapped = sum(1 for s in swaps if s is not None)
    discarded = len(swaps) - swapped

    qps = requests * batch / wall
    metrics = {
        "model": f"serve_threaded_{model}",
        "n": n,
        "batch": batch,
        "requests": requests,
        "threads": threads,
        "concurrent_qps": qps,
        "query_ms_p50": sorted(latencies)[len(latencies) // 2] * 1e3,
        "async_refreshes_swapped": swapped,
        "async_refreshes_discarded": discarded,
        "final_n": session.n,
        "cache_version": session.cache_info.version,
        "cache_staleness": session.cache_info.staleness,
    }
    if verbose:
        print(
            f"[{model} x{threads} threads] n={n}→{session.n} | "
            f"{requests} x {batch}-pt queries: {qps:,.0f} pts/s concurrent "
            f"(p50 {metrics['query_ms_p50']:.1f} ms) | double-buffered "
            f"refreshes: {swapped} swapped, {discarded} discarded | "
            f"cache v{metrics['cache_version']}"
        )
    return metrics


def _inject_operator(op, schedule, negative_diag=0.0):
    """Thread a FaultInjectingOperator INSIDE the AddedDiag wrapper, so the
    preconditioner still sees the K + σ²I structure it is built from."""
    if isinstance(op, AddedDiagOperator):
        return AddedDiagOperator(
            FaultInjectingOperator(op.base, schedule=schedule, negative_diag=negative_diag),
            op.sigma2,
        )
    return FaultInjectingOperator(op, schedule=schedule, negative_diag=negative_diag)


class _ChaosModel:
    """GP model wrapper that injects faults at the operator seam.

    Delegates the whole protocol to the wrapped model and overrides only
    the engine-facing cache paths (``operator`` / ``posterior_cache`` /
    ``update_cache``), so every mBCG solve runs against a
    :class:`FaultInjectingOperator` driven by one shared live
    :class:`FaultSchedule` — the drill toggles it mid-run."""

    def __init__(self, base, schedule, negative_diag=0.0):
        self._base = base
        self.schedule = schedule
        self.negative_diag = negative_diag

    def __getattr__(self, name):
        return getattr(self._base, name)

    def operator(self, params, data):
        return _inject_operator(self._base.operator(params, data), self.schedule,
                                self.negative_diag)

    def posterior_cache(self, params, data, y, *, generator=None, variance_cache=True):
        return build_posterior_cache(
            self.operator(params, data), self._base._tensor(y),
            self._base._generator(generator), self._base.settings,
            variance_cache=variance_cache,
        )

    def update_cache(self, params, data, y, cache, X_new, y_new):
        return extend_posterior_cache(self.operator(params, data), self._base._tensor(y), cache,
                                      self._base.settings)


def run_serve_chaos(
    *,
    n: int = 128,
    d: int = 2,
    batch: int = 64,
    requests_per_phase: int = 6,
    threads: int = 4,
    max_cg_iters: int = 40,
    nan_rate: float = 1.0,
    latency_s: float = 0.0,
    breaker_threshold: int = 2,
    breaker_reset_s: float = 0.3,
    seed: int = 0,
    device=None,
    verbose: bool = True,
    session_hook=None,
    timeout_s: float | None = None,
) -> dict:
    """The fault-injection drill: serve through injected faults, assert the
    robustness stack absorbed them.

    Four phases over one threaded :class:`PosteriorSession` (ExactGP,
    ``precision="mixed"``, ``on_failure="degrade"``):

      1. **clean** — build + serve, schedule inactive (health baseline);
      2. **nan** — ``nan_rate`` corrupts the bf16 matmuls only; a streamed
         ``observe`` refreshes the cache through a solve that goes
         unhealthy, and the ladder's ``precision_f32`` rung heals it;
      3. **outage** — every matmul and ``to_dense`` goes NaN; a params
         nudge invalidates the cache, guarded rebuilds exhaust their
         retries, the breaker opens, and queries serve the last consistent
         cache flagged degraded;
      4. **recovery** — faults off, the cool-down elapses, the half-open
         trial rebuild succeeds and the breaker re-closes.

    Returns the metric row; ``chaos_ok`` is the gate (exit status)."""
    X, y = _toy(seed, n, d)
    gp = build_model("exact", max_cg_iters=max_cg_iters, precision="mixed", device=device)
    gp.settings = dataclasses.replace(gp.settings, on_failure="degrade")
    dev = gp.device
    params = gp.init_params(X)
    schedule = FaultSchedule(seed, reduced_only=True, latency_s=latency_s)
    chaos = _ChaosModel(gp, schedule)
    session = PosteriorSession(
        chaos, params, X, y,
        max_staleness=8,
        query_deadline_s=60.0,
        rebuild_retries=1,
        rebuild_backoff_s=0.01,
        breaker_threshold=breaker_threshold,
        breaker_reset_s=breaker_reset_s,
    )
    if session_hook is not None:
        session_hook(session)

    unhandled: list = []
    handled_failures: list = []
    latencies: list = []
    lat_lock = threading.Lock()

    def one_query(r):
        Xq = _query_batch(seed, r, batch, d)
        t0 = time.perf_counter()
        try:
            session.query(Xq)
            _sync(dev)
        except Exception as e:  # noqa: BLE001 — the drill counts, never hides
            with lat_lock:
                unhandled.append(repr(e))
            return
        with lat_lock:
            latencies.append(time.perf_counter() - t0)

    def fire_queries(pool, base, k=requests_per_phase):
        _results([pool.submit(one_query, base + r) for r in range(k)], timeout_s)

    def esc_count():
        with session._lock:
            return sum(1 for rep in session.health_reports for rung in rep.rungs
                       if rung.rung == "precision_f32")

    with warnings.catch_warnings():
        # degrade-path warnings are the EXPECTED signal here; count them via
        # the health reports instead
        warnings.simplefilter("ignore", SolveHealthWarning)
        t_start = time.perf_counter()
        pool = ThreadPoolExecutor(max_workers=threads)
        try:
            # phase 1: clean serving baseline
            session.query(_query_batch(seed, 10_000, batch, d))
            _sync(dev)
            clean_reports = list(session.health_reports)
            fire_queries(pool, 0)

            # phase 2: NaN in the bf16 matmuls; the streamed observe
            # refreshes the cache through the degradation ladder
            schedule.nan_rate = nan_rate
            Xn, yn = _observation(seed, 0, 1, d)
            try:
                session.observe(Xn, yn)
            except Exception as e:  # noqa: BLE001
                handled_failures.append(("observe_nan", repr(e)))
            fire_queries(pool, 100)
            escalations = esc_count()
            nan_injected = len(schedule.injected)  # all on bf16 calls (reduced_only)

            # phase 3: total outage — rebuilds cannot succeed at ANY rung
            schedule.nan_rate = 0.0
            schedule.total_outage = True
            session.update_params({k: v + 1e-6 for k, v in session.params.items()})
            Xn, yn = _observation(seed, 1, 1, d)
            try:
                session.observe(Xn, yn)
            except Exception as e:  # noqa: BLE001
                handled_failures.append(("observe_outage", repr(e)))
            fire_queries(pool, 200)
            degraded_after_outage = session.degraded_queries
            breaker_opened = any(to == CircuitBreaker.OPEN
                                 for _, to, _ in session.breaker.transitions)

            # phase 4: recovery — faults off, cool-down, half-open trial
            schedule.total_outage = False
            time.sleep(breaker_reset_s + 0.05)
            fire_queries(pool, 300)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
        wall = time.perf_counter() - t_start

    stats = session.health_stats()
    lat_sorted = sorted(latencies)
    total = len(latencies) + len(unhandled)
    with session._lock:
        heal_s = next((r.duration_s for rep in session.health_reports for r in rep.rungs
                       if r.rung == "precision_f32" and r.status == CONVERGED), None)
    opened = [t for _, to, t in stats["breaker_transitions"] if to == CircuitBreaker.OPEN]
    closed = [t for _, to, t in stats["breaker_transitions"] if to == CircuitBreaker.CLOSED]
    metrics = {
        "model": "serve_chaos_exact",
        "n": n,
        "batch": batch,
        "threads": threads,
        "requests": total,
        "wall_s": wall,
        "query_ms_p50": lat_sorted[len(lat_sorted) // 2] * 1e3 if lat_sorted else float("nan"),
        "query_ms_p99": (lat_sorted[min(len(lat_sorted) - 1, int(len(lat_sorted) * 0.99))] * 1e3
                         if lat_sorted else float("nan")),
        "error_rate": len(unhandled) / total if total else 0.0,
        "unhandled_exceptions": len(unhandled),
        "handled_failures": len(handled_failures),
        "clean_build_status": [r.status for r in clean_reports],
        "precision_escalations": escalations,
        "heal_ms": heal_s * 1e3 if heal_s is not None else float("nan"),
        "breaker_open_s": closed[-1] - opened[0] if opened and closed else float("nan"),
        "degraded_queries": stats["degraded_queries"],
        "rebuild_failures": stats["rebuild_failures"],
        "breaker_transitions": len(stats["breaker_transitions"]),
        "breaker_path": [CircuitBreaker.CLOSED] + [t for _, t, _ in stats["breaker_transitions"]],
        "breaker_state": stats["breaker_state"],
        "fault_calls": schedule.calls,
        "fault_injected": len(schedule.injected),
        "fault_injected_bf16": nan_injected,
    }
    metrics["chaos_ok"] = bool(
        not unhandled
        and escalations >= 1
        and degraded_after_outage >= 1
        and breaker_opened
        and stats["breaker_state"] == CircuitBreaker.CLOSED
    )
    if verbose:
        print(
            f"[chaos exact] {total} queries, {len(unhandled)} unhandled | "
            f"{escalations} precision escalation(s), "
            f"{stats['degraded_queries']} degraded quer"
            f"{'y' if stats['degraded_queries'] == 1 else 'ies'}, "
            f"{stats['rebuild_failures']} rebuild failure(s) | breaker "
            f"{'→'.join(metrics['breaker_path'])} | "
            f"{schedule.calls} matmul calls, {len(schedule.injected)} injected | "
            f"p50 {metrics['query_ms_p50']:.1f} ms p99 {metrics['query_ms_p99']:.1f} ms | "
            f"{'OK' if metrics['chaos_ok'] else 'FAILED'}"
        )
        for e in unhandled[:5]:
            print(f"  unhandled: {e}")
    return metrics


def _health_payload(session) -> dict:
    """/health JSON: the session's health_stats() once one is serving."""
    if session is None:
        return {"status": "starting"}
    stats = session.health_stats()
    stats["status"] = "serving"
    return stats


def main(argv=None, *, on_metrics_server=None):
    """The CLI.  ``on_metrics_server(server)``, for an in-process caller,
    fires once the ``--metrics-port`` server is up (its ``url`` names the
    port, ephemeral under ``--metrics-port 0``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="sgpr", choices=list(MODELS),
                    help="sgpr | blr | dkl | exact | multitask (ski is ROADMAP Queue A "
                    "step 15b and raises)")
    ap.add_argument("--num-tasks", type=int, default=2,
                    help="T for --model multitask (ignored otherwise)")
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--d", type=int, default=2)
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--observe-every", type=int, default=5,
                    help="observe new points after every k-th request (0=never)")
    ap.add_argument("--observe-batch", type=int, default=1)
    ap.add_argument("--max-staleness", type=int, default=8)
    ap.add_argument("--max-basis-columns", type=int, default=0,
                    help="Rayleigh–Ritz compact the streamed Krylov cache past this "
                    "many columns (0 = unbounded)")
    ap.add_argument("--fit-steps", type=int, default=0,
                    help="Adam steps before serving (0 = serve at init params)")
    ap.add_argument("--max-cg-iters", type=int, default=25)
    ap.add_argument("--precision", default=None, choices=["highest", "mixed"])
    ap.add_argument("--threads", type=int, default=0,
                    help="run the concurrent thread-pool driver with this many query "
                    "workers (0 = sequential driver)")
    ap.add_argument("--chaos", action="store_true",
                    help="run the fault-injection drill over the threaded driver "
                    "(NaN injection -> ladder escalation -> outage -> breaker -> "
                    "recovery); exits nonzero unless the robustness stack absorbed "
                    "every fault")
    ap.add_argument("--chaos-nan-rate", type=float, default=1.0,
                    help="per-matmul NaN probability during the injection phase "
                    "(seeded; 1.0 = every bf16 call)")
    ap.add_argument("--chaos-latency", type=float, default=0.0,
                    help="artificial per-matmul host latency (seconds)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus /metrics + /health JSON on this localhost "
                    "port for the run (installs the obs metrics registry; 0 = an "
                    "ephemeral port, printed at startup)")
    ap.add_argument("--metrics-hold", type=float, default=0.0,
                    help="keep the metrics endpoint up this many seconds after the "
                    "run (a scrape window for a finished run)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must be present); "
                    "'cpu' runs the plain versions of the kernels")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    server = None
    holder: dict = {}
    hook = None
    if args.metrics_port is not None:
        if obs.active() is None:
            obs.install()
        server = obs.MetricsServer(
            port=args.metrics_port,
            health_fn=lambda: _health_payload(holder.get("session")),
        ).start()
        hook = lambda s: holder.__setitem__("session", s)  # noqa: E731
        print(f"[obs] metrics: {server.url}/metrics  health: {server.url}/health", flush=True)
        if on_metrics_server is not None:
            on_metrics_server(server)
    try:
        if args.chaos:
            metrics = run_serve_chaos(
                n=args.n, d=args.d, batch=args.batch,
                threads=max(args.threads, 2), max_cg_iters=args.max_cg_iters,
                nan_rate=args.chaos_nan_rate, latency_s=args.chaos_latency,
                seed=args.seed, device=args.device, session_hook=hook,
            )
            if not metrics["chaos_ok"]:
                sys.exit(1)
            return metrics
        common = dict(
            model=args.model, n=args.n, d=args.d, requests=args.requests, batch=args.batch,
            observe_every=args.observe_every, observe_batch=args.observe_batch,
            max_staleness=args.max_staleness, fit_steps=args.fit_steps,
            max_cg_iters=args.max_cg_iters, precision=args.precision,
            max_basis_columns=args.max_basis_columns, num_tasks=args.num_tasks,
            seed=args.seed, device=args.device, session_hook=hook,
        )
        if args.threads > 0:
            return run_serve_threaded(threads=args.threads, **common)
        return run_serve(**common)
    finally:
        if server is not None:
            if args.metrics_hold > 0:
                print(f"[obs] holding {server.url} for {args.metrics_hold:.0f}s (scrape window)",
                      flush=True)
                time.sleep(args.metrics_hold)
            server.stop()


if __name__ == "__main__":
    main()

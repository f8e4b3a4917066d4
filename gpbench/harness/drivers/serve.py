"""Driver ``serve``: a posterior served while rows stream in.

Set-up builds a ``PosteriorSession`` over the cell's n rows (the first
build, the "start"), and warms up the shapes the window uses: a query, a
second full build, an append computed and dropped.

The window runs ``clients`` closed-loop client threads, each sending
``query_points``-point queries back to back (a pool of ``query_pool``
batches a client, drawn from the seed, cycled), and one writer thread that
calls ``observe`` with ``observe_rows`` new rows every ``observe_period_s``
seconds on a fixed schedule.  A query's latency runs from its send to its
answer on the host (mean and variance copied back); every query sent
before the window closes is waited for.  ``serve_points_per_s`` counts the
points of the queries answered by the close.

What the reference is held to (``judge``): a sample, drawn from the seed,
of the answers with the cache version that served each (the mean and the
variance worked out again from that cache's weights and Rayleigh–Ritz pair),
and the caches themselves where the reference can work them out from the
inputs alone or from the version before: the start build and the window's
last rebuild from scratch (weights and Gram), one sampled append from the
weights of the version it extended.
"""

from __future__ import annotations

import random
import threading
import time

import torch

from gpbench.harness import chip, program
from gpbench.harness.cell import Outcome
from gpbench.reference import gp as ref


def run(ctx) -> Outcome:
    from repro_torch.serving import PosteriorSession

    cfg, mix = ctx.config, ctx.traffic
    dev = ctx.device
    n0, k_rows, s = cfg["n"], mix["observe_rows"], mix["query_points"]
    period = mix["observe_period_s"]
    X0, y0 = program.make_rows(n0, cfg, program.generator(ctx.seed, "data", dev), dev)
    n_obs = int(ctx.seconds / period) + 1
    Xo, yo = program.make_rows(n_obs * k_rows, cfg, program.generator(ctx.seed, "observe", dev), dev)
    qgen = program.generator(ctx.seed, "queries", dev)
    pools = [[torch.rand((s, cfg["d"]), generator=qgen, device=dev) * 2 - 1
              for _ in range(mix["query_pool"])] for _ in range(mix["clients"])]
    rng = random.Random(program.sub_seed(ctx.seed, "sample"))
    # one append of the window, drawn from the seed (every (max_staleness + 1)-th
    # observe rebuilds)
    sampled_append = rng.choice([k for k in range(max(1, int(ctx.seconds / period) - 1))
                                 if k % (mix["max_staleness"] + 1) != mix["max_staleness"]])

    gp = program.exact_gp(cfg, "serving", dev)
    raw = program.raw_hyperparameters(cfg["served_hyperparameters"])
    params = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in raw.items()}
    if "altered_answer" in ctx.faults:
        _alter_answers(gp)
    ctx.mark("data")
    session = PosteriorSession(gp, params, X0, y0, max_staleness=mix["max_staleness"])
    start_cache = session.cache
    ctx.mark("first build")
    # warm-up: a query, a second full build, an append computed and dropped
    session.query(pools[0][0])
    session.rebuild()
    with torch.no_grad():
        gp.update_cache(params, torch.cat([X0, Xo[:k_rows]]), torch.cat([y0, yo[:k_rows]]),
                        session.cache, Xo[:k_rows], yo[:k_rows])
    chip.sync(dev)

    stop = threading.Event()
    go = threading.Barrier(mix["clients"] + 2)
    queries = [[] for _ in range(mix["clients"])]  # (t_send, t_answer, points, n, m, failed)
    kept = []  # (client, query index, Xq, answer on the host, Served)
    observes = []  # (due, t_start, t_end, path, n, basis columns after, before)
    caches = {}
    failures = []
    clock = {}

    def keep(c, j) -> bool:  # about one answer in 64, drawn from the seed
        return program.sub_seed(ctx.seed, f"keep:{c}:{j}") % 64 == 0

    def client(c):
        pool, log = pools[c], queries[c]
        go.wait()
        j = 0
        while not stop.is_set():
            Xq = pool[j % len(pool)]
            t_send = time.perf_counter()
            try:
                with ctx.span("query"):
                    (mean, var), served = session.query_served(Xq)
                    answer = torch.stack([mean, var]).cpu()
            except Exception as e:  # noqa: BLE001 — counted as failed, the client goes on
                log.append((t_send, time.perf_counter(), Xq.shape[0], 0, 0, True))
                failures.append(repr(e))
            else:
                log.append((t_send, time.perf_counter(), Xq.shape[0], served.info.n,
                            int(served.cache.basis.shape[1]), False))
                if keep(c, j):
                    kept.append((c, j, Xq, answer, served))
            j += 1

    def writer():
        go.wait()
        for k in range(n_obs):
            due = clock["t0"] + (k + 1) * period
            if due >= clock["t_close"]:
                break
            time.sleep(max(0.0, due - time.perf_counter()))
            rows = slice(k * k_rows, (k + 1) * k_rows)
            before = session.cache
            t_start = time.perf_counter()
            try:
                with ctx.span("observe"):
                    path = session.observe(Xo[rows], yo[rows])
            except Exception as e:  # noqa: BLE001 — counted as failed
                failures.append(repr(e))
                observes.append((due, t_start, time.perf_counter(), "error", session.n, 0, 0))
                continue
            after = session.cache
            observes.append((due, t_start, time.perf_counter(), path, session.n,
                             int(after.basis.shape[1]), int(before.basis.shape[1])))
            if path == "rebuild":
                caches["rebuild"] = (session.n, after)
            elif k == sampled_append:
                caches["append"] = (session.n, before.alpha, after.alpha)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(mix["clients"])]
    threads.append(threading.Thread(target=writer))
    for t in threads:
        t.start()
    clock["t0"] = ctx.window_start()
    clock["t_close"] = clock["t0"] + ctx.seconds
    go.wait()
    time.sleep(max(0.0, clock["t_close"] - time.perf_counter()))
    stop.set()
    for t in threads:
        t.join(timeout=300)
    clock["t1"] = ctx.window_stop()
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client or the writer did not finish within 300 s of the close")

    t0, t_close = clock["t0"], clock["t_close"]
    flat = [q for log in queries for q in log]
    ok = [q for q in flat if not q[5]]
    records = {
        "window_s": t_close - t0,
        "points": sum(q[2] for q in ok if q[1] <= t_close),
        "latencies_ms": [(q[1] - q[0]) * 1e3 for q in ok],
        "queries": [(q[2], q[3], q[4]) for q in ok if q[1] <= t_close],  # (points, n, m)
        "observes": [{"due_s": o[0] - t0, "ms": (o[2] - o[1]) * 1e3, "late_ms": (o[1] - o[0]) * 1e3,
                      "path": o[3], "n": o[4], "basis": o[5], "basis_before": o[6]}
                     for o in observes],
    }
    kept.sort(key=lambda q: q[:2])
    sample = [q[2:] for q in rng.sample(kept, min(len(kept), mix["sampled_queries"]))]
    start = (n0, start_cache)
    del session, gp, start_cache, kept, threads
    inputs = (torch.cat([X0, Xo]), torch.cat([y0, yo]))
    return Outcome(records=records, attempted=len(flat) + len(observes), failed=len(failures),
                   judge=lambda: judge(ctx, inputs, sample, start, caches),
                   control=lambda rounding: judge(ctx, inputs, sample, start, caches, rounding))


def _alter_answers(gp):
    """Fault ``altered_answer``: every served mean's first entry is off by one."""
    serve = gp.predict_cached

    def altered(*args, **kwargs):
        mean, var = serve(*args, **kwargs)
        mean = mean.clone()
        mean[0] += 1.0
        return mean, var

    gp.predict_cached = altered


def served_hyperparameters(ctx):
    """(ℓ, s, σ²) in float64 from the raw values the program is handed,
    which are float32."""
    raw = program.raw_hyperparameters(ctx.config["served_hyperparameters"])
    return tuple(ref.softplus(torch.tensor(raw[f"raw_{k}"], dtype=torch.float32,
                                           device=ctx.device).double())
                 for k in ("lengthscale", "outputscale", "noise"))


def judge(ctx, inputs, sample, start, caches, control=None) -> list:
    """The numbers compared; with ``control`` (a rounding) the reference at
    that precision stands in the program's place."""
    X, y = inputs
    s = ctx.config["serving"]
    ell, out, sig2 = served_hyperparameters(ctx)
    solve = dict(rank=s["precond_rank"], jitter=s.get("precond_jitter", 1e-8),
                 max_iters=s["max_cg_iters"], tol=s["cg_tol"])
    mean_gap = var_gap = 0.0
    for Xq, answer, served in sample:
        c, n = served.cache, served.info.n
        args = (X[:n], Xq, ell, out, sig2, c.alpha, c.basis, c.gram_chol)
        m, v = ref.cached_answer(*args)
        if control is not None:
            answer = torch.stack(ref.cached_answer(*args, rounding=control))
        mean_gap = max(mean_gap, _gap(answer[0], m))
        var_gap = max(var_gap, _gap(answer[1], v))
    probe = sample[0][0] if sample else X[:ctx.traffic["query_points"]]
    builds = [start] + ([caches["rebuild"]] if "rebuild" in caches else [])
    build_gap = gram_gap = 0.0
    for n, cache in builds:
        alpha = ref.posterior_weights(X[:n], y[:n], ell, out, sig2, **solve)
        G = ref.build_gram(X[:n], ell, out, sig2, cache.basis)
        if control is None:
            got_alpha, got_G = cache.alpha, cache.gram_chol.double() @ cache.gram_chol.double().T
        else:
            got_alpha = ref.posterior_weights(X[:n], y[:n], ell, out, sig2, rounding=control,
                                              **solve)
            got_G = ref.build_gram(X[:n], ell, out, sig2, cache.basis, rounding=control)
        build_gap = max(build_gap, _mean_gap(X[:n], probe, ell, out, sig2, got_alpha, alpha))
        gram_gap = max(gram_gap, _gap(got_G, G))
    nums = [("query_mean_gap", mean_gap), ("query_var_gap", var_gap),
            ("build_mean_gap", build_gap), ("gram_gap", gram_gap)]
    if "append" in caches:
        n, alpha_before, alpha_after = caches["append"]
        u0 = torch.nn.functional.pad(alpha_before.double(), (0, n - alpha_before.shape[0]))
        alpha = ref.posterior_weights(X[:n], y[:n], ell, out, sig2, u0=u0, **solve)
        if control is not None:
            alpha_after = ref.posterior_weights(X[:n], y[:n], ell, out, sig2, u0=u0,
                                                rounding=control, **solve)
        nums.append(("append_mean_gap",
                     _mean_gap(X[:n], probe, ell, out, sig2, alpha_after, alpha)))
    return nums


def _gap(a, b) -> float:
    """Largest difference over the largest reference magnitude."""
    a, b = a.to(b.device, torch.float64), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _mean_gap(X, probe, ell, out, sig2, alpha, alpha_ref) -> float:
    K = ref.KernelMatrix(X, ell, out, sig2)
    Kxs = K.cross(X, probe)
    return _gap(Kxs.T @ alpha.double(), Kxs.T @ alpha_ref.double())

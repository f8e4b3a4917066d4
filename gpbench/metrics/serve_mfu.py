"""serve_mfu: the window's algorithm operations over (the card's busy time
× the peak of the cell's precision): every answered query's cross
covariance, mean, projection and Gram solves at the version that served
it, and the B1 products of the window's builds and appends.  The busy
time is the union of the traced window's device intervals, so the
profiler's host cost does not enter; the idle share is
``device_idle.serve``'s."""

from gpbench.harness import readers, work


def read(run):
    r = run.records
    if "queries" not in r or run.trace is None or run.trace.busy_s <= 0:
        return None
    c = run.config
    ops = sum(work.query(n, s, c["d"], m, c["kernel_type"])[0] for s, n, m in r["queries"])
    ops += sum(w[0] for w in readers.observe_products(run))
    return 100.0 * ops / (run.trace.busy_s * work.PEAK_FLOPS[c["precision"]])

"""train_mfu: the window's algorithm operations over (the card's busy time
× the peak of the cell's precision), both from the traced window.  The
work is counted once: the CG iterations the window's solves ran (the
program's ``cg_iterations`` histogram, one fused iteration each), and per
step the backward's product and its vector-Jacobian product.  The busy
time is the union of the device's intervals, so the profiler's host cost
does not enter; the card's idle share is ``device_idle.train``'s."""

from gpbench.harness import readers, work


def read(run):
    steps = run.records.get("steps")
    iters = readers.histogram_totals(run.registry, "cg_iterations")
    if not steps or iters is None or run.trace is None or run.trace.busy_s <= 0:
        return None
    c = run.config
    t = c["training"]["num_probes"] + 1
    n, d, k = c["n"], c["d"], c["kernel_type"]
    ops = iters[0] * work.b3(n, d, t, k)[0] + steps * (work.b1(n, n, d, t, k)[0]
                                                        + work.grad(n, d, t)[0])
    return 100.0 * ops / (run.trace.busy_s * work.PEAK_FLOPS[c["precision"]])

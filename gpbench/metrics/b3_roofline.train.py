"""b3_roofline.train: B3's least time per launch (one fused CG iteration
over the (n, t + 1) state, work counted once at the cell's peak) over its
device time per launch, from the trace."""

from gpbench.harness import work


def read(run):
    fam = run.trace.families().get("B3") if run.trace is not None else None
    if not fam or not fam["calls"]:
        return None
    c = run.config
    ops, nbytes = work.b3(c["n"], c["d"], c["training"]["num_probes"] + 1, c["kernel_type"])
    return 100.0 * fam["calls"] * work.least_seconds(ops, nbytes, c["precision"]) / fam["seconds"]

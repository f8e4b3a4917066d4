"""b1_roofline.train: B1's least time per launch over its device time per
launch, from the trace.  Every B1 launch of a training step is a product
K̂·M with M (n, t + 1): the backward's primal and, at precision "mixed",
the f32 residual refreshes."""

from gpbench.harness import work


def read(run):
    fam = run.trace.families().get("B1") if run.trace is not None else None
    if not fam or not fam["calls"]:
        return None
    c = run.config
    ops, nbytes = work.b1(c["n"], c["n"], c["d"], c["training"]["num_probes"] + 1,
                          c["kernel_type"])
    return 100.0 * fam["calls"] * work.least_seconds(ops, nbytes, c["precision"]) / fam["seconds"]

"""b1_roofline.serve: the least time of the B1 products that the window's
builds and appends need, over B1's device time in the trace.

A rebuild at n: max_cg_iters products with num_probes + 1 columns and the
Gram's product with its m basis columns; an append: the residual's and
max_cg_iters products with one column and the new directions' product
(the columns the basis gained).  Products that an implementation adds
(the f32 refreshes at precision "mixed") add time and no work."""

from gpbench.harness import readers, work


def read(run):
    fam = run.trace.families().get("B1") if run.trace is not None else None
    if not fam or not fam["calls"]:
        return None
    least = sum(work.least_seconds(*w, run.config["precision"])
                for w in readers.observe_products(run))
    return 100.0 * least / fam["seconds"] if least else None

"""cg_iters.train: CG iterations per solve, the mean of the program's
``cg_iterations`` histogram over the traced window."""

from gpbench.harness import readers


def read(run):
    return readers.histogram_mean(run.registry, "cg_iterations")

"""device_idle.train: the share of the traced window in which no
operation ran on the card (1 − union of device intervals ÷ window)."""

from gpbench.harness import readers


def read(run):
    return readers.idle_share(run.trace)

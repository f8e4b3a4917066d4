"""train_step_ms: the window's seconds over the Adam steps completed in it."""


def read(run):
    steps = run.records.get("steps")
    return run.records["window_s"] / steps * 1e3 if steps else None

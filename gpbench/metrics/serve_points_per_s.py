"""serve_points_per_s: query points answered in the window over the
window's seconds."""

from gpbench.harness import stats


def read(run):
    if "points" not in run.records:
        return None
    return stats.rate(run.records["points"], run.records["window_s"])

"""query_p95_ms: the 95th percentile of every query's latency, send to
answer, over all queries sent in the window."""

from gpbench.harness import stats


def read(run):
    lat = run.records.get("latencies_ms")
    return stats.percentile(lat, 95.0) if lat else None

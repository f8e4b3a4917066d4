"""Arithmetic that several metric readers share."""

from __future__ import annotations


def histogram_totals(snapshot, name: str):
    """(sum, count) over every series of histogram ``name``; None if empty."""
    fam = (snapshot or {}).get(name)
    if not fam:
        return None
    total = sum(s["sum"] for s in fam["series"].values())
    count = sum(s["count"] for s in fam["series"].values())
    return (total, count) if count else None


def histogram_mean(snapshot, name: str):
    """Sum over count of every series of histogram ``name`` (None if empty)."""
    totals = histogram_totals(snapshot, name)
    return totals[0] / totals[1] if totals else None


def idle_share(trace):
    """100 × (1 − busy ÷ window); None without a trace that saw the card."""
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def observe_products(run):
    """(operations, bytes) of every B1 product the window's observes need."""
    from . import work

    c = run.config
    s = c["serving"]
    n_d, k = c["d"], c["kernel_type"]
    out = []
    for o in run.records.get("observes", []):
        n = o["n"]
        if o["path"] == "rebuild":
            out += [work.b1(n, n, n_d, s["num_probes"] + 1, k)] * s["max_cg_iters"]
            out.append(work.b1(n, n, n_d, o["basis"], k))
        elif o["path"] == "append":
            out += [work.b1(n, n, n_d, 1, k)] * (s["max_cg_iters"] + 1)
            if o["basis"] > o["basis_before"]:
                out.append(work.b1(n, n, n_d, o["basis"] - o["basis_before"], k))
    return out

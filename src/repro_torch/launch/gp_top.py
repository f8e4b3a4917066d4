"""gp_top — terminal summary of the BBMM metrics registry (counterpart of
``repro.launch.gp_top``, the same code).

The non-serving exposition surface: where ``gp_serve --metrics-port``
feeds a Prometheus scraper, ``gp_top`` renders the same registry as a
human-readable table — one-shot or watch-mode — for long fits, million-row
solves and benchmark runs:

    # scrape a live gp_serve endpoint (default http://127.0.0.1:9100)
    PYTHONPATH=src python -m repro_torch.launch.gp_top --url http://127.0.0.1:9100/metrics

    # refresh every 2 s until interrupted
    PYTHONPATH=src python -m repro_torch.launch.gp_top --watch 2

    # render a scraped-to-disk snapshot (e.g. `curl .../metrics > m.txt`)
    PYTHONPATH=src python -m repro_torch.launch.gp_top --file m.txt

Counters and gauges print per label set; histograms print count / mean and
bucket-estimated p50/p99 (the upper edge of the first bucket holding the
quantile — honest to half a decade, which is what fixed log buckets buy;
"+Inf" when the quantile lies past the last edge, where the reference's
copy raises OverflowError).
"""

from __future__ import annotations

import argparse
import math
import sys
import time
import urllib.error
import urllib.request

from repro_torch.obs import parse_prometheus

DEFAULT_URL = "http://127.0.0.1:9100/metrics"


def fetch(url: str, timeout: float = 5.0) -> str:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _labels_str(labels: dict) -> str:
    items = [(k, v) for k, v in sorted(labels.items()) if k != "__part"]
    return ",".join(f"{k}={v}" for k, v in items) if items else "-"


def _quantile_edge(buckets: list, q: float):
    """Upper edge of the first cumulative bucket reaching quantile q."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    target = q * total
    for edge, cum in buckets:
        if cum >= target:
            return edge
    return buckets[-1][0]


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, str):
        return v
    if not math.isfinite(v):
        return "+Inf" if v > 0 else str(v)
    av = abs(v)
    if v == int(v) and av < 1e6:
        return str(int(v))
    if av >= 1e4 or (0 < av < 1e-3):
        return f"{v:.3g}"
    return f"{v:.4f}"


def render(families: dict) -> str:
    """Registry snapshot -> aligned terminal table."""
    rows: list = []  # (section, name, labels, cols...)
    for name in sorted(families):
        fam = families[name]
        if fam["type"] == "histogram":
            # regroup this family's component samples per label set
            per_label: dict = {}
            for labels, value in fam["samples"]:
                part = labels.get("__part", "value")
                key = tuple(
                    sorted(
                        (k, v)
                        for k, v in labels.items()
                        if k not in ("__part", "le")
                    )
                )
                entry = per_label.setdefault(key, {"buckets": []})
                if part == "bucket":
                    edge = labels.get("le", "+Inf")
                    entry["buckets"].append(
                        (float("inf") if edge == "+Inf" else float(edge), value)
                    )
                else:
                    entry[part] = value
            for key, entry in sorted(per_label.items()):
                count = entry.get("count", 0)
                mean = entry.get("sum", 0.0) / count if count else None
                buckets = sorted(entry["buckets"])
                p50 = _quantile_edge(buckets, 0.50)
                p99 = _quantile_edge(buckets, 0.99)
                rows.append(
                    (
                        "histograms (count / mean / ~p50 / ~p99)",
                        name,
                        _labels_str(dict(key)),
                        f"{_fmt(count)}  {_fmt(mean)}  {_fmt(p50)}  {_fmt(p99)}",
                    )
                )
        else:
            section = "counters" if fam["type"] == "counter" else "gauges"
            for labels, value in sorted(
                fam["samples"], key=lambda s: _labels_str(s[0])
            ):
                rows.append((section, name, _labels_str(labels), _fmt(value)))

    if not rows:
        return "(no metrics — is a registry installed / endpoint scraped?)"
    rows.sort(key=lambda r: (r[0], r[1], r[2]))  # one block per section
    out: list = []
    w_name = max(len(r[1]) for r in rows)
    w_lab = max(len(r[2]) for r in rows)
    current = None
    for section, name, labels, cols in rows:
        if section != current:
            if current is not None:
                out.append("")
            out.append(f"== {section} ==")
            current = section
        out.append(f"  {name:<{w_name}}  {labels:<{w_lab}}  {cols}")
    return "\n".join(out)


def snapshot_text(args) -> str:
    """Fetch the exposition text from whichever source was configured."""
    if args.file:
        with open(args.file) as f:
            return f.read()
    return fetch(args.url)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--url", default=DEFAULT_URL,
                    help=f"metrics endpoint to scrape (default {DEFAULT_URL})")
    ap.add_argument("--file", default=None,
                    help="render a saved exposition-format file instead of "
                    "scraping --url")
    ap.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="refresh every SECS seconds until interrupted "
                    "(0 = one shot)")
    ap.add_argument("--raw", action="store_true",
                    help="print the raw Prometheus text instead of the table")
    args = ap.parse_args(argv)

    while True:
        try:
            text = snapshot_text(args)
        except (urllib.error.URLError, OSError) as e:
            print(f"gp_top: cannot read metrics ({e})", file=sys.stderr)
            if not args.watch:
                return 1
            time.sleep(args.watch)
            continue
        body = text if args.raw else render(parse_prometheus(text))
        if args.watch:
            src = args.file or args.url
            print(f"\x1b[2J\x1b[H[gp_top] {src} @ {time.strftime('%H:%M:%S')}")
        print(body)
        if not args.watch:
            return 0
        time.sleep(args.watch)


if __name__ == "__main__":
    sys.exit(main())

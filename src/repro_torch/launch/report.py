"""The dry-run and roofline tables from the dry-run's artifacts — the
counterpart of ``repro.launch.report``:

    PYTHONPATH=src python -m repro_torch.launch.report [--dir dryrun_out] [--mesh 16x16]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from .dryrun import ARTIFACT_DIR


def fmt_bytes(b):
    return f"{b/2**30:.2f}"


def fmt_s(x):
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.1f}µs"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def load(dirname):
    rows = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def dryrun_table(rows):
    out = [
        "| arch | shape | mesh | status | mem/dev GiB | compile s |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} | "
            f"{r.get('per_device_gib', '-')} | {r.get('compile_seconds', '-')} |"
        )
    return "\n".join(out)


def roofline_table(rows, mesh="16x16"):
    out = [
        "| arch | shape | t_comp | t_mem | t_coll | bottleneck | useful | overlap-bound | MFU-bound |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("status") != "ok" or r.get("mesh") != mesh:
            continue
        a = r["analysis"]
        ob = a.get("t_overlap_bound", max(a["t_compute"], a["t_memory"], a["t_collective"]))
        mfu = a.get("mfu_bound", 0.0)
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(a['t_compute'])} | "
            f"{fmt_s(a['t_memory'])} | {fmt_s(a['t_collective'])} | "
            f"{a['bottleneck']} | {a['useful_ratio']:.2f} | {fmt_s(ob)} | {mfu:.3f} |"
        )
    return "\n".join(out)


def summarize(rows):
    ok = [r for r in rows if r.get("status") == "ok"]
    err = [r for r in rows if r.get("status") != "ok"]
    lines = [f"cells: {len(rows)}  ok: {len(ok)}  error: {len(err)}"]
    for r in err:
        lines.append(f"  ERROR {r['arch']} {r['shape']} {r['mesh']}: {r.get('error','')[:120]}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=ARTIFACT_DIR)
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    rows = load(args.dir)
    print(summarize(rows))
    print("\n## Dry-run\n")
    print(dryrun_table(rows))
    print(f"\n## Roofline ({args.mesh})\n")
    print(roofline_table(rows, args.mesh))


if __name__ == "__main__":
    main()

"""Run one cell of the port's benchmark and print its result line.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for; it exits with a non-zero code and prints no result without them.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpbench.harness import chip  # noqa: E402

T_PROC = chip.process_start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gpbench.harness.cell import run_cell
    from gpbench.harness.spec import Spec

    spec = Spec()
    chip.require_cards(spec.cell(args.workload)["chips"])
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), spec=spec,
                      t_proc=T_PROC)
    forbidden = chip.loaded_forbidden()
    if forbidden:
        print(f"gpbench: the run loaded {forbidden}; the port may load none of them",
              file=sys.stderr)
        return 4
    for what, at in result.pop("setup_marks"):
        print(f"setup {what} at {at:.3f} s", file=sys.stderr)
    for what, note in result.pop("window_notes").items():
        print(f"window {what} {json.dumps(note)}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings for the correctness limits of a cell, and the served
hyperparameters of a configuration.  Not run by the benchmark's runs.

    python3 gpbench/calibrate.py --workload <cell> --seeds 1,2,3 [--controls 3] [--seconds 2]
    python3 gpbench/calibrate.py --workload <cell> --fit-steps 200 --seeds 1

For each seed, in one process: the cell's set-up and a window of
``--seconds`` through its driver, then every number compared (the program
against the reference: the lower reading) and, for the first ``--controls``
seeds, the same numbers with the reference one precision below the
configuration's in the program's place (the control: the upper reading).
``--fault`` runs the window with the timed path broken underneath (a
fault's reading), ``--detail`` adds the readings behind the numbers.
``--fit-steps`` instead fits the configuration's ExactGP to the seed's data
(``fit``, Adam at the mix's lr) and prints the fitted hyperparameters.
Each line is a JSON object on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gpbench.harness import cell as cells  # noqa: E402
from gpbench.harness import chip, program  # noqa: E402
from gpbench.harness.spec import Spec  # noqa: E402

#: the control's precision: one below the configuration's
CONTROL = {"highest": "tf32", "mixed": "fp8"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=0)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fit-steps", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--fault", default="", help="break the timed path (a fault's reading)")
    p.add_argument("--detail", action="store_true", help="the readings behind the numbers")
    p.add_argument("--cell", default="",
                   help='JSON of a cell BENCHMARK.json does not list yet, e.g. '
                        '{"config": "exact-matern52-kin40k", "traffic": "stream"}')
    p.add_argument("--override", default="{}",
                   help='JSON merged into the cell, e.g. {"config": {"n": 300}} (rehearsals)')
    args = p.parse_args(argv)
    spec = Spec()
    if args.cell:  # a cell to calibrate before it is added
        spec.benchmark["workloads"].append({"name": args.workload, "chips": 1,
                                            **json.loads(args.cell)})
        cfg = json.loads(args.cell)["config"]
        if all(c["name"] != cfg for c in spec.benchmark["configs"]):
            spec.benchmark["configs"].append({"name": cfg, "file": f"gpbench/configs/{cfg}.json"})
    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.time()
        if args.fit_steps:
            line = {"seed": seed, "fitted": fit(spec, args.workload, seed, args.fit_steps,
                                                args.device)}
        else:
            ctx, outcome = cells.drive(spec, args.workload, seed, args.seconds, False,
                                       device=args.device, overrides=json.loads(args.override),
                                       faults=(args.fault,) if args.fault else ())
            line = {"seed": seed, "fault": args.fault or None, "program": dict(outcome.judge())}
            rounding = CONTROL[ctx.config["precision"]]
            if i < args.controls:
                line["control"] = {"rounding": rounding, **dict(outcome.control(rounding))}
            if args.detail and outcome.detail is not None:
                line["detail"] = outcome.detail(rounding)
            del ctx, outcome
        line["seconds"] = time.time() - t0
        line["device"] = chip.device_record(args.device, 1)
        print(json.dumps({"workload": args.workload, **line}), flush=True)
    return 0


def fit(spec, name, seed, steps, device) -> dict:
    import torch

    c = spec.cell(name)
    cfg, mix = spec.config(c["config"]), spec.traffic("fit")
    program.import_program()
    X, y = program.make_rows(cfg["n"], cfg, program.generator(seed, "data", device), device)
    gp = program.exact_gp(cfg, "training", device)
    params, history = gp.fit(X, y, steps=steps, lr=mix["lr"],
                             generator=program.generator(seed, "probes", device))
    soft = {k[len("raw_"):]: float(torch.nn.functional.softplus(v)) for k, v in params.items()}
    return {"steps": steps, "lr": mix["lr"], "loss_first": history[0], "loss_last": history[-1],
            "hyperparameters": soft}


if __name__ == "__main__":
    sys.exit(main())

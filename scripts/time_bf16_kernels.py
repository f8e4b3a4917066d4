#!/usr/bin/env python3
"""Time the bf16 kernel-matrix kernels and the GP training step on the card,
for one source tree: this checkout, or another one (a parent commit
unpacked with ``git archive`` into a gitignored directory), so that two
trees can be compared on one card in one run, in turns:

    python3 scripts/time_bf16_kernels.py [--tree PATH] [--label NAME]

Builds the tree's kernels (into the tree's own ``_build``), then prints one
JSON line: the card's name and power limit (``nvidia-smi``), and

  * bf16 B1 at t = 9, 234 and 256, B2 at b = 4, t = 9 and B3 at t = 9, on
    X/ℓ of n = 40,000 points, d = 8 (``chip_smoke.make_data``'s uniform
    inputs over ℓ = 0.5, rounded to bf16 as the mixed policy stores them),
    Matérn-5/2: ms a launch, CUDA events around synchronised launches
    (``chip_smoke.time_ms``), each case's input made once;
  * the fused ExactGP training step (Matérn-5/2, 8 probes, 25 CG
    iterations, precond_rank 0) on ``chip_smoke.make_data``'s n = 40,000 at
    precision="mixed" and "highest": ms of each of 5 synchronised Adam
    steps, the first cold.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]),
                    help="root of the source tree to time (default: this checkout)")
    ap.add_argument("--label", default=None, help="a name for the tree in the output")
    ap.add_argument("--n", type=int, default=40_000)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_bf16_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings
    from repro_torch.kernels import build
    from repro_torch.kernels.kernel_matmul import kernel_matmul as km

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    n, d = args.n, 8
    rng = np.random.default_rng(0)
    X, y = cs.make_data(rng, n, d)
    Xb = torch.from_numpy(X / 0.5).to(dev).to(torch.bfloat16).float()
    kernels = {}
    for label, shape in (("B1_t9", (n, 9)), ("B1_t234", (n, 234)), ("B1_t256", (n, 256)),
                         ("B2_b4_t9", (4, n, 9))):
        M = torch.from_numpy(rng.standard_normal(shape).astype("float32")).to(dev)
        kernels[label] = cs.time_ms(lambda: km.kernel_matmul_cuda(  # noqa: B023
            Xb, Xb, M, 1.0, 0.0, kernel_type="matern52", compute_dtype="bfloat16"), reps=10)
        del M
    state, scalars = cs._cg_inputs(rng, dev, 1, n, 9)
    kernels["B3_t9"] = cs.time_ms(lambda: km.fused_cg_step_cuda(
        Xb, Xb, *state, *state[1:], *scalars, 1.0, 0.1, kernel_type="matern52",
        compute_dtype="bfloat16"), reps=10)
    del state, scalars
    torch.cuda.empty_cache()

    Xd, yd = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    settings = BBMMSettings(num_probes=8, max_cg_iters=25, precond_rank=0)
    steps = {}
    for precision in ("mixed", "highest"):
        gp = ExactGP(kernel_type="matern52", mode="cuda", fuse_cg=True, settings=settings,
                     precision=precision)
        ms, clock = [], [0.0]

        def on_step(i, loss, ms=ms, clock=clock):
            torch.cuda.synchronize()
            now = time.perf_counter()
            ms.append((now - clock[0]) * 1e3)
            clock[0] = time.perf_counter()

        torch.cuda.synchronize()
        clock[0] = time.perf_counter()
        gp.fit(Xd, yd, steps=args.steps, callback=on_step)
        steps[precision] = ms
    print(json.dumps({"tree": args.label or str(tree), "card": card, "build_s": build_s,
                      "n": n, "d": d, "kernel_ms": kernels, "train_step_ms": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

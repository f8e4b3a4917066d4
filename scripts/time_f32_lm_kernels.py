#!/usr/bin/env python3
"""Time B4 (flash attention) and B5 (the SSD scan) in float32 on the card,
for one source tree: this checkout, or another one (a parent commit
unpacked with ``git archive`` into a gitignored directory), so that two
trees can be compared on one card in one run, in turns:

    python3 scripts/time_f32_lm_kernels.py [--tree PATH] [--label NAME]

Builds the tree's kernels (into the tree's own ``_build``), then prints one
JSON line: the card's name and power limit (``nvidia-smi``), and for every
model's f32 shape on the model's (b, s, h, dh) / conv-output views —

  * B4 at zamba2-7b's shared block (4 × 512², 32 heads, dh 224, causal),
    llama3.2-1b's, qwen1.5-110b's and command-r-plus-104b's prefills,
    whisper-large-v3's encoder (1,500² non-causal) and its decode
    cross-attention (1 × 1,500);
  * B5 at zamba2-7b's (112 heads, dh 64, ds 64) and mamba2-370m's (32
    heads, dh 64, ds 128) scans, chunk 128 —

ms a launch of the tree's entry point (CUDA events around synchronised
launches, ``chip_smoke.time_ms``), the route it took, the plain version's
ms, ``scaled_dot_product_attention`` in f32 beside B4 (a yardstick the port
never calls, with the backend it picked), and the bound with f32 products
priced as 3xTF32 and as CUDA-core f32.  The timing code is this checkout's
(``chip_smoke.time_f32_lm``); the kernels are the tree's.

Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE),
                    help="root of the source tree to time (default: this checkout)")
    ap.add_argument("--label", default=None, help="a name for the tree in the output")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    # the tree's kernels, this checkout's timing code
    sys.path[:0] = [str(tree / "src"), str(HERE)]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_f32_lm_kernels: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    rows = cs.time_f32_lm(np.random.default_rng([args.seed, 28]))
    print(json.dumps({"tree": args.label or str(tree), "card": card, "build_s": build_s,
                      "torch": torch.__version__,
                      "kernels": {key: row["shapes"] for key, row in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

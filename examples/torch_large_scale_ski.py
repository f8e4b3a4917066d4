"""SKI / KISS-GP at scale with the PyTorch / H100 port: n = 100,000 points,
as ``examples/large_scale_ski.py`` does with the JAX package.

    PYTHONPATH=src python examples/torch_large_scale_ski.py                       # on the GPU
    PYTHONPATH=src python examples/torch_large_scale_ski.py --device cpu --n 5000

The blackbox matmul is O(n + m log m): sparse cubic interpolation onto a
2,048-point grid and the grid kernel's Toeplitz product through the FFT
(``torch.fft``; no kernel of the port's own).  Trains 30 Adam steps (10
probes, 30 CG iterations, no preconditioner), prints the milliseconds per
step and the test MAE on 2,000 held-out points (all of them where fewer
are held out); run as a script it asserts the JAX example's bar, MAE <
0.4, which is that of n = 100,000 (the JAX example misses it at 5,000,
and at 30,000–60,000).  The mean is served from the posterior cache
(``predict_cached``: ``predict``'s mean bit for bit, without its solve
against all 2,000 test columns).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import SKI
from repro_torch.core import BBMMSettings
from repro_torch.data import RegressionStream

STEPS = 30
MAE_BAR = 0.4


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" runs without a GPU (default: CUDA)')
    parser.add_argument("--n", type=int, default=100_000, help="points (90 %% train, 10 %% test)")
    args = parser.parse_args(argv)

    (Xtr, ytr), (Xte, yte) = RegressionStream(args.n, 1, seed=3, kind="multiscale").split()
    gp = SKI(
        grid_size=2048,
        settings=BBMMSettings(num_probes=10, max_cg_iters=30, precond_rank=0),
        device=args.device,
    )

    def sync():
        if gp.device.type == "cuda":
            torch.cuda.synchronize(gp.device)

    def report(step, loss):
        if step % 10 == 9:
            print(f"step {step + 1:3d}  -mll/n {loss / len(ytr):+.4f}", flush=True)

    sync()
    t0 = time.perf_counter()
    params, history = gp.fit(Xtr, ytr, steps=STEPS, lr=0.1, callback=report)
    sync()
    ms_per_step = (time.perf_counter() - t0) / STEPS * 1e3

    geom = gp.prepare_inputs(Xtr)
    with torch.no_grad():
        cache = gp.posterior_cache(params, geom, ytr)
        mean, _ = gp.predict_cached(params, geom, cache, Xte[:2000])
    mae = float(np.mean(np.abs(mean.cpu().numpy() - yte[:2000])))
    print(f"\nn={args.n} ({len(ytr)} train) on {gp.device}: fit {STEPS} steps, "
          f"{ms_per_step:.1f} ms/step")
    print(f"test MAE: {mae:.4f} on {min(2000, len(yte))} points")
    return {"n": args.n, "ms_per_step": ms_per_step, "mae": mae, "history": history}


if __name__ == "__main__":
    out = main()
    assert out["mae"] < MAE_BAR, f"large-scale SKI regression: MAE {out['mae']:.4f} ≥ {MAE_BAR}"

"""Quickstart of the PyTorch / H100 port: exact GP regression through the
BBMM engine, as ``examples/quickstart.py`` does with the JAX package.

    PYTHONPATH=src python examples/torch_quickstart.py                  # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu     # plain versions
    PYTHONPATH=src python examples/torch_quickstart.py --precision mixed

Trains the hyperparameters by Adam on the mBCG marginal log likelihood
(the hand-written kernels on the GPU, their plain PyTorch versions on the
CPU), then prints the test MAE and the 2σ coverage and asserts the MAE bar
of the JAX quickstart.  The bar is on training (BBMM-trained
hyperparameters against a dense-Cholesky-trained GP), so under
``--precision mixed`` it is applied to the mixed-trained hyperparameters
served at "highest"; the mean served at "mixed" (bf16 operands in the
mean contraction, as the reference serves it) is printed beside it.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import ExactGP
from repro_torch.core import BBMMSettings
from repro_torch.data import RegressionStream


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" runs without a GPU (default: CUDA)')
    parser.add_argument("--precision", choices=("highest", "mixed"), default="highest")
    args = parser.parse_args(argv)

    (Xtr, ytr), (Xte, yte) = RegressionStream(800, 2, seed=0, kind="smooth").split()

    gp = ExactGP(
        kernel_type="matern52",
        mode="cuda",
        settings=BBMMSettings(num_probes=10, max_cg_iters=25, precond_rank=5),
        precision=args.precision,
        device=args.device,
    )
    params, history = gp.fit(Xtr, ytr, steps=80, lr=0.1)

    def served(model):
        with torch.no_grad():
            mean, var = model.predict(params, Xtr, ytr, Xte)
        mean, var = mean.cpu().numpy(), var.cpu().numpy()
        return float(np.mean(np.abs(mean - yte))), float(np.mean(np.abs(mean - yte) < 2 * np.sqrt(var)))

    mae, coverage = served(gp)
    print(f"device / precision: {gp.device} / {args.precision}")
    print(f"test MAE          : {mae:.4f}")
    print(f"2σ coverage       : {coverage:.2%} (want ≈95%)")
    print(f"-MLL: {history[0]:.1f} → {history[-1]:.1f}")
    bar_mae = mae
    if args.precision != "highest":
        bar_mae, _ = served(dataclasses.replace(gp, precision="highest"))
        print(f"test MAE served at highest: {bar_mae:.4f}")
    # the JAX quickstart's parity bar: a dense-Cholesky-trained GP reaches
    # MAE ≈ 0.32 on this dataset — BBMM training must match it
    assert bar_mae < 0.35, f"quickstart regression: MAE {bar_mae:.4f} ≥ 0.35"
    return mae, bar_mae


if __name__ == "__main__":
    main()

"""End-to-end GP training with the PyTorch / H100 port, as
``examples/train_gp_e2e.py`` does with the JAX package: SGPR on 50,000
points for a few hundred Adam steps, checkpointed and preemption-safe.

    PYTHONPATH=src python examples/torch_train_gp_e2e.py                  # on the GPU
    PYTHONPATH=src python examples/torch_train_gp_e2e.py --device cpu --n 5000 --steps 60

The substrate path of the LM driver (``repro_torch.launch.train``) with a
GP in the model's place: the data pipeline → SGPR (the Woodbury-root
operator, mBCG) → Adam (``repro_torch.optim``) → async checkpointing every
25 steps → the straggler watchdog and the preemption handler.  Prints the
milliseconds per step and the test MAE on up to 2,000 held-out points;
run as a script it asserts the JAX example's bar, MAE < 0.35.
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import SGPR
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import BBMMSettings
from repro_torch.data import RegressionStream
from repro_torch.distributed import PreemptionHandler, StragglerWatchdog
from repro_torch.optim import adam
from repro_torch.tree import tree_leaves, tree_unflatten

MAE_BAR = 0.35


def run(n=50_000, steps=200, device=None, ckpt_dir=None):
    """Train, checkpoint and predict; returns {"mae", "ms_per_step",
    "checkpoints", "stragglers", "losses"}."""
    (Xtr, ytr), (Xte, yte) = RegressionStream(n, 4, seed=11, kind="smooth").split()
    gp = SGPR(num_inducing=128, kernel_type="matern52",
              settings=BBMMSettings(num_probes=10, max_cg_iters=20, precond_rank=0),
              device=device)
    data, y = gp.prepare_inputs(Xtr), torch.as_tensor(ytr, device=gp.device)
    params = gp.init_params(Xtr)
    init, update = adam(0.05)
    opt = init(params)
    gen = torch.Generator(device=gp.device)
    gen.manual_seed(0)

    def step(params, opt):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = gp.loss(tree_unflatten(params, leaves), data, y, gen)
        grads = torch.autograd.grad(loss, leaves)
        params, opt = update(tree_unflatten(params, list(grads)), opt, params)
        return params, opt, loss.detach()

    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="gp_ckpt_")
    ck = Checkpointer(ckpt_dir, keep=2)
    watchdog = StragglerWatchdog()
    losses = []
    t0 = time.perf_counter()
    with PreemptionHandler() as preempt:
        for i in range(steps):
            watchdog.step_start()
            params, opt, loss = step(params, opt)
            losses.append(float(loss))  # waits for the step's kernels
            watchdog.step_end(i)
            if i % 25 == 0:
                print(f"step {i:4d}  -mll/n {losses[-1] / len(ytr):.4f}", flush=True)
                ck.save_async(i, params)
            if preempt.requested:
                ck.save(i, params)
                print("preempted — checkpointed and exiting")
                return None
    ck.wait()
    dt = time.perf_counter() - t0

    mean, _ = gp.predict(params, data, y, Xte[:2000])
    mae = float(np.mean(np.abs(mean.detach().cpu().numpy() - yte[:2000])))
    out = {"mae": mae, "ms_per_step": dt / steps * 1e3, "checkpoints": ck.all_steps(),
           "stragglers": watchdog.straggler_count, "losses": losses}
    print(f"\n{steps} steps on n={len(ytr)} in {dt:.1f}s ({out['ms_per_step']:.0f} ms/step) — "
          f"test MAE {mae:.4f}, stragglers={out['stragglers']}, ckpts={out['checkpoints']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--device", default=None, help='"cpu" runs without a GPU (default: CUDA)')
    args = ap.parse_args(argv)
    out = run(args.n, args.steps, args.device)
    if out is not None:
        assert out["mae"] < MAE_BAR, out["mae"]


if __name__ == "__main__":
    main()

"""Serving-traffic demo of the PyTorch / H100 port: a versioned
PosteriorSession answering many posterior queries with zero CG iterations,
streaming new observations in — ``examples/posterior_serving.py`` on the
port.

    PYTHONPATH=src python examples/torch_posterior_serving.py                # on the GPU
    PYTHONPATH=src python examples/torch_posterior_serving.py --device cpu   # plain versions

The session builds the posterior cache once (the hand-written K̂·M kernel
on the GPU, its plain PyTorch version on the CPU), fingerprints it against
(params, X, y), serves repeated mean / variance requests with no mBCG run,
and folds appended observations in incrementally (warm-started CG and
Krylov-basis recycling).  After a rebuild the cached mean is bitwise the
uncached prediction's, and the cached variance is conservative: the
Rayleigh–Ritz projection never reports less than the exact posterior's,
up to the uncached variance's own CG tolerance.  The data are drawn from
numpy under ``--seed`` (the reference draws them with ``jax.random``).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import ExactGP
from repro_torch.core import BBMMSettings
from repro_torch.serving import PosteriorSession

N, REQUESTS, POINTS = 1500, 20, 256


def _f(X):
    return np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default=None, help='"cpu" runs without a GPU (default: CUDA)')
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    X = (rng.uniform(size=(N, 2)) * 2 - 1).astype(np.float32)
    y = (_f(X) + 0.05 * rng.standard_normal(N)).astype(np.float32)

    gp = ExactGP(mode="cuda", device=args.device,
                 settings=BBMMSettings(num_probes=10, max_cg_iters=25, precond_rank=5))
    params = gp.init_params(2)

    def sync():
        if gp.device.type == "cuda":
            torch.cuda.synchronize(gp.device)

    with torch.no_grad():
        t0 = time.perf_counter()
        session = PosteriorSession(gp, params, X, y, max_staleness=8)
        sync()
        t_build = time.perf_counter() - t0
        info = session.cache_info
        print(f"cache v{info.version} built in {t_build * 1e3:.0f} ms  (n={N}, {gp.device})")

        # request traffic: batches of query points
        queries = [(rng.uniform(size=(POINTS, 2)) * 2 - 1).astype(np.float32)
                   for _ in range(REQUESTS)]
        t0 = time.perf_counter()
        for Xq in queries:
            mean, var = session.query(Xq)
        sync()
        t_query = (time.perf_counter() - t0) / REQUESTS
        print(f"{REQUESTS} requests x {POINTS} points: {t_query * 1e3:.1f} ms/request (CG-free)")

        # stream two new observations in: an incremental update, not a rebuild
        Xn = (rng.uniform(size=(2, 2)) * 2 - 1).astype(np.float32)
        path = session.observe(Xn, _f(Xn).astype(np.float32))
        info = session.cache_info
        print(f"observe -> {path}  (cache v{info.version}, n={info.n}, "
              f"staleness={info.staleness})")

        # the cached mean against the uncached prediction on the updated data
        Xq = queries[0]
        mean_c, _ = session.query(Xq)
        session.rebuild()  # the async-refresh hook, run inline here
        mean_r, var_r = session.query(Xq)
        err = float((mean_c - mean_r).abs().max())
        print(f"streamed vs rebuilt mean: max |d| = {err:.2e} (cg_tol {gp.settings.cg_tol:g})")
        mean_u, var_u = gp.predict(params, session.X, session.y, Xq)
    assert bool(torch.equal(mean_r, mean_u)), "cached mean must be bitwise identical"
    # conservative against the exact posterior; var_u is itself CG-approximate
    # (tol 1e-4), so its convergence slack is allowed, as in the reference
    slack = float((var_u - var_r).max())
    assert bool(torch.all(var_r >= var_u - 2e-2)), "cached variance must be conservative"
    print("bitwise mean identity + conservative variance: OK")
    return {"build_ms": t_build * 1e3, "query_ms": t_query * 1e3, "observe": path,
            "streamed_vs_rebuilt": err, "variance_slack": slack,
            "mean_bitwise": True, "n": info.n}


if __name__ == "__main__":
    main()

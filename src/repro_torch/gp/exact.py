"""Exact GP regression through the BBMM engine (counterpart of
``repro.gp.exact``).

Training — ``loss`` (−MLL) and ``fit`` (:func:`repro_torch.gp.training.fit_gp`)
— and serving — ``posterior_cache`` / ``predict_cached`` / ``predict``,
inherited from :class:`repro_torch.gp.model.KrylovCachePredictor`.  The
hyperparameters are the reference's raw (softplus-inverse) values, so the
reference's parameters carry over through
:func:`repro_torch.convert.params_from_jax`.  ``loss`` takes y (n,) or
(b, n) — b targets of one kernel in one engine call (multi-output, (b,)
losses) — and ``batched_loss`` b hyperparameter sets (multi-restart, b
dense kernel matrices in one engine call).  Streaming appends —
``update_cache`` — are inherited too (warm-started CG with Krylov-basis
recycling).

``mode="cuda"`` runs every blackbox K̂·M through the hand-written CUDA
kernel, its gradient through the gradient kernel, and — with
``fuse_cg=True`` and ``precond_rank=0`` — every CG iteration as one fused
kernel launch; ``device`` defaults to CUDA and must be given as ``"cpu"``
to run the plain path without a GPU.  ``precision="mixed"`` runs the CG
loop's kernels with bf16 operands and f32 residual refreshes, the served
mean with bf16 operands; the gradient stays f32.  ``mode="cuda_partitioned"``
streams K one row-panel at a time (``settings.panel_rows`` /
``panel_budget_bytes``; ``panel_backend`` "auto" | "cuda" | "torch").
``mode="cuda_sharded"`` (the reference's ``pallas_sharded``) shards the
kernel's rows over the ambient :func:`repro_torch.distributed.use_mesh`
mesh: every rank of the world calls ``loss`` / ``fit`` / ``posterior_cache``
with the same data and parameters, launches on its own row band and
gathers the rest, so every rank holds the same bits (``fuse_cg=True``: the
sharded B3 step); under a live mesh ``cuda_partitioned`` shards its panel
stream the same way.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch

from repro_torch.core import (
    AddedDiagOperator,
    BatchDenseOperator,
    BBMMSettings,
    marginal_log_likelihood,
)
from repro_torch.device import resolve_device

from .kernels import KernelOperator, MaternKernel, RBFKernel
from .model import KrylovCachePredictor
from .training import fit_gp


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y: float) -> float:
    return math.log(math.expm1(y))


KERNELS = {
    "rbf": RBFKernel,
    "matern52": partial(MaternKernel, nu=2.5),
    "matern32": partial(MaternKernel, nu=1.5),
    "matern12": partial(MaternKernel, nu=0.5),
}


@dataclasses.dataclass
class ExactGP(KrylovCachePredictor):
    kernel_type: str = "rbf"
    # the blackbox matmul: dense | blocked | cuda | cuda_partitioned | cuda_sharded
    mode: str = "dense"
    block_size: int = 512
    panel_backend: str = "auto"  # cuda_partitioned: auto | cuda | torch
    settings: BBMMSettings = dataclasses.field(default_factory=BBMMSettings)
    # None → CUDA (raises without a GPU); "cpu" runs the plain path
    device: torch.device | str | None = None
    # end-to-end precision knob: "highest" (all f32) or "mixed" (bf16 kernel
    # operands, f32 accumulation, periodic f32 residual refresh in mBCG).
    # None follows ``settings.precision``; an explicit value wins, so
    # replace(gp, precision="highest") switches a mixed model back.
    # ``settings.precision`` is what the engine reads either way.
    precision: str | None = None
    # fused-CG knob: True runs each mBCG iteration as ONE fused kernel launch
    # where the operator has one (the cuda modes; dense/blocked keep the
    # unfused loop).  Requires precond_rank=0 (mbcg raises otherwise).  None
    # follows ``settings.fuse_cg``; an explicit value wins.
    fuse_cg: bool | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.precision is not None:
            self.settings = dataclasses.replace(self.settings, precision=self.precision)
        if self.fuse_cg is not None:
            self.settings = dataclasses.replace(self.settings, fuse_cg=self.fuse_cg)
        if self.kernel_type not in KERNELS:
            raise ValueError(f"kernel_type must be one of {sorted(KERNELS)}")

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- GPModel protocol: inputs / parameterization --------------------------
    def prepare_inputs(self, X):
        """Exact GP has no hyperparameter-free geometry: data IS X."""
        return self._tensor(X)

    def init_params(self, X, ard: bool = False):
        d = X if isinstance(X, int) else X.shape[-1]
        full = partial(torch.full, dtype=torch.float32, device=self.device)
        return {
            "raw_lengthscale": full((d,) if ard else (), _inv_softplus(0.5)),
            "raw_outputscale": full((), _inv_softplus(1.0)),
            "raw_noise": full((), _inv_softplus(0.1)),
        }

    def kernel(self, params):
        return KERNELS[self.kernel_type](
            lengthscale=_softplus(params["raw_lengthscale"]),
            outputscale=_softplus(params["raw_outputscale"]),
        )

    def operator(self, params, data) -> AddedDiagOperator:
        extra = {}
        if self.mode == "cuda_partitioned":
            extra = {
                "panel_rows": self.settings.panel_rows,
                "panel_budget_bytes": self.settings.panel_budget_bytes,
                "panel_backend": self.panel_backend,
            }
        base = KernelOperator(
            kernel=self.kernel(params),
            X=self._tensor(data),
            mode=self.mode,
            block_size=self.block_size,
            **extra,
        )
        return AddedDiagOperator(base, self.noise(params))

    def noise(self, params):
        return _softplus(params["raw_noise"])

    # -- training -------------------------------------------------------------
    def loss(self, params, data, y, generator):
        """−MLL, differentiable in ``params`` (and y); ``generator`` draws
        the probes.  y (b, n) gives (b,) losses from one engine call (the
        probes shared across the b targets)."""
        return -marginal_log_likelihood(
            self.operator(params, data), self._tensor(y), generator, self.settings
        )

    def fit(self, X, y, *, steps=100, lr=0.1, generator=None, callback=None):
        return fit_gp(self, X, y, steps=steps, lr=lr, generator=generator, callback=callback)

    # -- multi-restart ----------------------------------------------------------
    def batched_operator(self, params_batch, X) -> AddedDiagOperator:
        """K̂ for b hyperparameter sets as ONE batched operator: every leaf
        of ``params_batch`` carries a leading (b,) dim.  The b kernel
        matrices are materialized (as the reference does, outside any
        kernel), and the engine solves all b problems in one mBCG call.
        Their exact diagonals k(x, x) go beside them, so the batched
        preconditioner pivots as a loop of ``operator`` does."""
        X = self._tensor(X)
        b = params_batch["raw_noise"].shape[0]
        kernels = [self.kernel({k: v[i] for k, v in params_batch.items()}) for i in range(b)]
        Ks = torch.stack([k(X, X) for k in kernels])
        diag = torch.stack([k.diag(X) for k in kernels])
        return AddedDiagOperator(BatchDenseOperator(Ks, diag=diag),
                                 _softplus(params_batch["raw_noise"]))

    def batched_loss(self, params_batch, X, y, generator):
        """(b,) negative MLLs for b hyperparameter sets in one engine call;
        ``y`` is (n,) (shared targets) or (b, n)."""
        op = self.batched_operator(params_batch, X)
        y = self._tensor(y)
        yb = y.expand(op.base.batch, y.shape[-1]) if y.dim() == 1 else y
        return -marginal_log_likelihood(op, yb, generator, self.settings)

"""Exact GP regression through the BBMM engine (counterpart of
``repro.gp.exact``).

Training — ``loss`` (−MLL) and ``fit`` (:func:`repro_torch.gp.training.fit_gp`)
— and serving — ``posterior_cache`` / ``predict_cached`` / ``predict``,
inherited from :class:`repro_torch.gp.model.KrylovCachePredictor`.  The
hyperparameters are the reference's raw (softplus-inverse) values, so the
reference's parameters carry over through
:func:`repro_torch.convert.params_from_jax`.  Batched evaluation and cache
updates come with later slices and raise ``NotImplementedError`` naming
the ROADMAP step that brings them.

``mode="cuda"`` runs every blackbox K̂·M through the hand-written CUDA
kernel, its gradient through the gradient kernel, and — with
``fuse_cg=True`` and ``precond_rank=0`` — every CG iteration as one fused
kernel launch; ``device`` defaults to CUDA and must be given as ``"cpu"``
to run the plain path without a GPU.  ``precision="mixed"`` runs the CG
loop's kernels with bf16 operands and f32 residual refreshes, the served
mean with bf16 operands; the gradient stays f32.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial

import torch

from repro_torch.core import AddedDiagOperator, BBMMSettings, marginal_log_likelihood
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


def _not_ported(what: str, step: str):
    return NotImplementedError(f"ExactGP.{what} is not ported yet: ROADMAP Queue A {step}")


@dataclasses.dataclass
class ExactGP(KrylovCachePredictor):
    kernel_type: str = "rbf"
    mode: str = "dense"  # dense | blocked | cuda (the blackbox matmul impl)
    block_size: int = 512
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
    # where the operator has one (mode="cuda"; dense/blocked keep the
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
        base = KernelOperator(
            kernel=self.kernel(params),
            X=self._tensor(data),
            mode=self.mode,
            block_size=self.block_size,
        )
        return AddedDiagOperator(base, self.noise(params))

    def noise(self, params):
        return _softplus(params["raw_noise"])

    # -- training -------------------------------------------------------------
    def loss(self, params, data, y, generator):
        """−MLL, differentiable in ``params`` (and y); ``generator`` draws
        the probes."""
        return -marginal_log_likelihood(
            self.operator(params, data), self._tensor(y), generator, self.settings
        )

    def fit(self, X, y, *, steps=100, lr=0.1, generator=None, callback=None):
        return fit_gp(self, X, y, steps=steps, lr=lr, generator=generator, callback=callback)

    # -- later slices ---------------------------------------------------------
    def batched_operator(self, params_batch, X):
        raise _not_ported("batched_operator", "step 11 (batched engine)")

    def batched_loss(self, params_batch, X, y, generator):
        raise _not_ported("batched_loss", "step 11 (batched engine)")

    def update_cache(self, params, data, y, cache, X_new, y_new):
        raise _not_ported("update_cache", "step 14 (streaming serving)")

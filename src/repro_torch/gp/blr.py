"""Bayesian linear regression as a GP (paper §5; counterpart of
``repro.gp.blr``).

K̂ = (X·s)(X·s)ᵀ + σ²I — a :class:`LowRankRootOperator`: one BBMM matmul
costs O(t·n·d) in two plain contractions, and the root is its own
preconditioner factor.

Serving: :class:`repro_torch.gp.model.WoodburyCachePredictor` — the root
rows ARE the scaled features (no triangular map, ``Luu`` is None), so the
posterior has an exact d-dimensional Woodbury cache: O(s·d²) CG-free
queries and exact rank-k appends.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import (
    AddedDiagOperator,
    BBMMSettings,
    LowRankRootOperator,
    marginal_log_likelihood,
)
from repro_torch.device import resolve_device

from .exact import _inv_softplus, _softplus
from .model import WoodburyCachePredictor
from .training import fit_gp


@dataclasses.dataclass
class BayesianLinearRegression(WoodburyCachePredictor):
    # precond_rank > 0 selects the exact low-rank-root preconditioner
    settings: BBMMSettings = dataclasses.field(
        default_factory=lambda: BBMMSettings(precond_rank=1)
    )
    precision: str | None = None  # "highest" | "mixed"; None follows settings
    fuse_cg: bool | None = None  # no fused step: True runs the unfused loop
    # None → CUDA (raises without a GPU); "cpu" runs on the host
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.precision is not None:
            self.settings = dataclasses.replace(self.settings, precision=self.precision)
        if self.fuse_cg is not None:
            self.settings = dataclasses.replace(self.settings, fuse_cg=self.fuse_cg)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- GPModel protocol ------------------------------------------------------
    def prepare_inputs(self, X):
        return self._tensor(X)

    def init_params(self, X):
        d = X if isinstance(X, int) else X.shape[-1]
        return {
            "raw_prior_scale": torch.full((d,), _inv_softplus(1.0), dtype=torch.float32,
                                          device=self.device),
            "raw_noise": torch.full((), _inv_softplus(0.1), dtype=torch.float32,
                                    device=self.device),
        }

    def _scaled(self, params, X):
        return self._tensor(X) * _softplus(params["raw_prior_scale"])[None, :]

    def operator(self, params, data):
        return AddedDiagOperator(LowRankRootOperator(self._scaled(params, data)),
                                 self.noise(params))

    def noise(self, params):
        return _softplus(params["raw_noise"])

    def loss(self, params, data, y, generator):
        return -marginal_log_likelihood(
            self.operator(params, data), self._tensor(y), generator, self.settings
        )

    def fit(self, X, y, *, steps=100, lr=0.05, generator=None, callback=None):
        return fit_gp(self, X, y, steps=steps, lr=lr, generator=generator, callback=callback)

    # -- serving cache (WoodburyCachePredictor hooks) --------------------------
    def _woodbury_root(self, params, data):
        return self._scaled(params, data), None

    def _woodbury_root_rows(self, params, Luu, Xq):
        # the root rows ARE the scaled features: no triangular map
        return self._scaled(params, Xq)

"""SGPR / SoR sparse GP through BBMM (paper §5; counterpart of
``repro.gp.sgpr``).

K̂ ≈ K_XU·K_UU⁻¹·K_UX + σ²I is a :class:`LowRankRootOperator` with root
R = K_XU·chol(K_UU)⁻ᵀ: R(RᵀM) costs O(t·n·m + t·m²), two plain matmuls and
no kernel launch.  The root is its own preconditioner factor, so CG
converges in O(1) iterations.  The inducing points U are an ordinary
differentiable parameter: the MLL's backward reaches them through the
root.

Serving: :class:`repro_torch.gp.model.WoodburyCachePredictor` — the SoR
posterior has a closed m-dimensional form, so the cache is exact, a query
costs O(s·m²) with no CG, and an append is an exact rank-k refresh.
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

from .exact import KERNELS, _inv_softplus, _softplus
from .model import WoodburyCachePredictor
from .training import fit_gp


@dataclasses.dataclass
class SGPR(WoodburyCachePredictor):
    num_inducing: int = 300
    kernel_type: str = "rbf"
    jitter: float = 1e-4
    # likelihood-noise floor: as σ² → 0 the SoR system turns singular and
    # truncated CG's biased estimates reward the collapse
    min_noise: float = 1e-3
    # precond_rank > 0 selects the exact low-rank-root preconditioner
    settings: BBMMSettings = dataclasses.field(
        default_factory=lambda: BBMMSettings(precond_rank=1, max_cg_iters=40)
    )
    # "highest" | "mixed" (the root contractions with bf16 operands, f32
    # accumulation, mBCG's f32 residual refresh); None follows settings
    precision: str | None = None
    # API uniformity with ExactGP: the root operator has no fused step, so
    # True runs the unfused loop.  None follows settings.fuse_cg
    fuse_cg: bool | None = None
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

    # -- GPModel protocol: inputs / parameterization --------------------------
    def prepare_inputs(self, X):
        return self._tensor(X)

    def init_params(self, X, generator: torch.Generator | None = None):
        """The inducing points start as a random subset of the training rows,
        drawn by ``generator`` (default: a CPU generator seeded with 0)."""
        X = self._tensor(X)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        idx = torch.randperm(X.shape[0], generator=generator)[: self.num_inducing]
        full = lambda v: torch.full((), _inv_softplus(v), dtype=torch.float32,  # noqa: E731
                                    device=self.device)
        return {
            "inducing": X[idx.to(X.device)],
            "raw_lengthscale": full(0.5),
            "raw_outputscale": full(1.0),
            "raw_noise": full(0.1),
        }

    def kernel(self, params):
        return KERNELS[self.kernel_type](
            lengthscale=_softplus(params["raw_lengthscale"]),
            outputscale=_softplus(params["raw_outputscale"]),
        )

    def _root(self, params, X):
        """(R, chol(K_UU + jitter·I)) with R·Rᵀ = K_XU·K_UU⁻¹·K_UX."""
        kern = self.kernel(params)
        U = params["inducing"]
        eye = torch.eye(U.shape[0], dtype=X.dtype, device=X.device)
        Luu = torch.linalg.cholesky(kern(U, U) + self.jitter * eye)
        R = torch.linalg.solve_triangular(Luu, kern(X, U).T, upper=False).T
        return R, Luu

    def noise(self, params):
        return _softplus(params["raw_noise"]) + self.min_noise

    def operator(self, params, data):
        R, _ = self._root(params, self._tensor(data))
        return AddedDiagOperator(LowRankRootOperator(R), self.noise(params))

    def loss(self, params, data, y, generator):
        return -marginal_log_likelihood(
            self.operator(params, data), self._tensor(y), generator, self.settings
        )

    def fit(self, X, y, *, steps=100, lr=0.05, generator=None, learn_inducing=True,
            callback=None):
        """Adam on the MLL; ``learn_inducing=False`` zeroes the inducing
        points' gradient each step (they stay as initialized, bit for
        bit)."""
        grad_mask = None
        if not learn_inducing:
            grad_mask = lambda g: dict(g, inducing=torch.zeros_like(g["inducing"]))  # noqa: E731
        return fit_gp(self, X, y, steps=steps, lr=lr, generator=generator,
                      callback=callback, grad_mask=grad_mask)

    # -- serving cache (WoodburyCachePredictor hooks) --------------------------
    def _woodbury_root(self, params, data):
        return self._root(params, self._tensor(data))

    def _woodbury_root_rows(self, params, Luu, Xq):
        """k(Xq, U) mapped into root coordinates by the cached chol(K_UU)."""
        Ksu = self.kernel(params)(self._tensor(Xq), params["inducing"])  # (q, m)
        return torch.linalg.solve_triangular(Luu, Ksu.T, upper=False).T

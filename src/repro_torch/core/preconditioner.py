"""Pivoted-Cholesky preconditioner P̂ = L_k L_kᵀ + σ²I (counterpart of
``repro.core.preconditioner``, single-device generic path).

All three operations the paper requires of a GP preconditioner are O(n·k²):

  * ``solve``   — Woodbury:  P̂⁻¹R = σ⁻²[R − L (σ²I_k + LᵀL)⁻¹ (LᵀR)]
  * ``logdet``  — matrix determinant lemma:
                  log|P̂| = (n−k)·log σ² + 2·Σ log diag chol(σ²I_k + LᵀL)
  * ``sample_probes`` — z = L g₁ + σ g₂ with Rademacher g, so cov(z) = P̂
                  exactly.  Driven by a ``torch.Generator``: the draws differ
                  from the reference's ``jax.random`` ones for the same seed,
                  so parity tests inject the reference's probes.
"""

from __future__ import annotations

import dataclasses

import torch

from .linear_operator import AddedDiagOperator, LinearOperator
from .pivoted_cholesky import pivoted_cholesky


def _rademacher(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    bits = torch.randint(0, 2, shape, generator=generator, device=device)
    return (2 * bits - 1).to(dtype)


@dataclasses.dataclass(frozen=True)
class PivotedCholeskyPreconditioner:
    L: torch.Tensor  # (n, k)
    sigma2: torch.Tensor  # scalar noise
    inner_chol: torch.Tensor  # (k, k) chol(σ²I_k + LᵀL)

    @staticmethod
    def build(L: torch.Tensor, sigma2) -> "PivotedCholeskyPreconditioner":
        k = L.shape[-1]
        sigma2 = torch.as_tensor(sigma2, dtype=L.dtype, device=L.device)
        eye = torch.eye(k, dtype=L.dtype, device=L.device)
        inner = sigma2 * eye + L.T @ L
        return PivotedCholeskyPreconditioner(L, sigma2, torch.linalg.cholesky(inner))

    def solve(self, R: torch.Tensor) -> torch.Tensor:
        """P̂⁻¹ @ R for R of shape (n, t) (or (n,) vector)."""
        squeeze = R.dim() == 1
        if squeeze:
            R = R[:, None]
        w = torch.cholesky_solve(self.L.T @ R, self.inner_chol)
        out = (R - self.L @ w) / self.sigma2
        return out[:, 0] if squeeze else out

    def matmul(self, M: torch.Tensor) -> torch.Tensor:
        """P̂ @ M (tests / residual checks)."""
        return self.L @ (self.L.T @ M) + self.sigma2 * M

    def logdet(self) -> torch.Tensor:
        n, k = self.L.shape
        diag = torch.diagonal(self.inner_chol)
        return (n - k) * torch.log(self.sigma2) + 2.0 * torch.sum(torch.log(diag))

    def sample_probes(self, generator: torch.Generator, num: int, n: int) -> torch.Tensor:
        """Draw ``num`` probes with covariance exactly P̂ (Rademacher base)."""
        k = self.L.shape[-1]
        g1 = _rademacher(generator, (k, num), self.L.dtype, self.L.device)
        g2 = _rademacher(generator, (n, num), self.L.dtype, self.L.device)
        return self.L @ g1 + torch.sqrt(self.sigma2) * g2

    def inv_quad(self, Z: torch.Tensor) -> torch.Tensor:
        """zᵀ P̂⁻¹ z per column — the SLQ probe normalization."""
        return torch.sum(Z * self.solve(Z), dim=-2)


@dataclasses.dataclass(frozen=True)
class IdentityPreconditioner:
    """No preconditioning: P̂ = I. Probes are plain Rademacher."""

    device: torch.device = torch.device("cpu")

    def solve(self, R):
        return R

    def matmul(self, M):
        return M

    def logdet(self):
        return torch.zeros((), dtype=torch.float32, device=self.device)

    def sample_probes(self, generator, num, n):
        return _rademacher(generator, (n, num), torch.float32, self.device)

    def inv_quad(self, Z):
        return torch.sum(Z * Z, dim=-2)


def build_preconditioner(op: LinearOperator, rank: int, *, jitter: float = 1e-8):
    """Build P̂ from an AddedDiagOperator K̂ = K + σ²I.

    The low-rank factor approximates the *base* kernel K from its rows and
    diagonal.  The preconditioner is a constant to autograd (built under
    ``no_grad``): gradient estimators stay unbiased for any fixed P̂."""
    if rank <= 0:
        return IdentityPreconditioner(device=op.device)
    if not isinstance(op, AddedDiagOperator):
        raise TypeError(
            "Preconditioning requires K̂ = K + σ²I (AddedDiagOperator); got "
            f"{type(op).__name__}"
        )
    base = op.base
    with torch.no_grad():
        L = pivoted_cholesky(base.row, base.diagonal(), rank, jitter=jitter)
        sigma2 = torch.as_tensor(op.sigma2, dtype=L.dtype, device=L.device)
        return PivotedCholeskyPreconditioner.build(L, sigma2.detach())

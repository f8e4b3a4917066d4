"""Pivoted-Cholesky preconditioner P̂ = L_k L_kᵀ + σ²I (counterpart of
``repro.core.preconditioner``).

All three operations the paper requires of a GP preconditioner are O(n·k²):

  * ``solve``   — Woodbury:  P̂⁻¹R = σ⁻²[R − L (σ²I_k + LᵀL)⁻¹ (LᵀR)]
  * ``logdet``  — matrix determinant lemma:
                  log|P̂| = (n−k)·log σ² + 2·Σ log diag chol(σ²I_k + LᵀL)
  * ``sample_probes`` — z = L g₁ + σ g₂ with Rademacher g, so cov(z) = P̂
                  exactly.  Driven by a ``torch.Generator``: the draws differ
                  from the reference's ``jax.random`` ones for the same seed,
                  so parity tests inject the reference's probes.

A low-rank-root base (:class:`LowRankRootOperator`, SGPR and BLR) is its
own factor: P̂ = RRᵀ + σ²I = K̂ exactly, so CG converges in O(1)
iterations whatever the requested rank.  A batched base
(:class:`BatchDenseOperator`, the multi-restart path) gets
one factor per batch element, L (b, n, k) with σ² (b,); the Rademacher
draws are shared across the batch, so a batched run uses the same
randomness as a loop of single runs from the same generator.  Under an
ambient mesh whose data axes divide n, the generic factor is built
row-sharded (:func:`pivoted_cholesky_sharded`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.distributed.sharding import batch_axes, current_mesh

from .linear_operator import (
    AddedDiagOperator,
    BatchDenseOperator,
    KroneckerAddedDiagOperator,
    LinearOperator,
    LowRankRootOperator,
)
from .pivoted_cholesky import pivoted_cholesky, pivoted_cholesky_sharded


def _precond_shard_axes(n: int) -> tuple:
    """The ambient mesh's data axes to row-shard the pivoted-Cholesky build
    over — () when there is no mesh, no data axis, one shard, or an n the
    shards do not divide (the build then stays replicated: correctness
    never depends on the sharding)."""
    mesh = current_mesh()
    axes = batch_axes()
    if mesh is None or not axes:
        return ()
    shards = mesh.num_shards(axes)
    return axes if shards > 1 and n % shards == 0 else ()


def _rademacher(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    bits = torch.randint(0, 2, shape, generator=generator, device=device)
    return (2 * bits - 1).to(dtype)


def _bcast_scalar(s: torch.Tensor, extra_dims: int = 2) -> torch.Tensor:
    """A scalar, or a (b,) batch of them, shaped to broadcast against
    (…, n, t)."""
    return s.reshape(s.shape + (1,) * extra_dims) if s.dim() else s


@dataclasses.dataclass(frozen=True)
class PivotedCholeskyPreconditioner:
    L: torch.Tensor  # (…, n, k)
    sigma2: torch.Tensor  # noise: scalar, or (b,) matching L's batch dims
    inner_chol: torch.Tensor  # (…, k, k) chol(σ²I_k + LᵀL)

    @staticmethod
    def build(L: torch.Tensor, sigma2) -> "PivotedCholeskyPreconditioner":
        k = L.shape[-1]
        sigma2 = torch.as_tensor(sigma2, dtype=L.dtype, device=L.device)
        eye = torch.eye(k, dtype=L.dtype, device=L.device)
        inner = _bcast_scalar(sigma2) * eye + L.transpose(-1, -2) @ L
        return PivotedCholeskyPreconditioner(L, sigma2, torch.linalg.cholesky(inner))

    def solve(self, R: torch.Tensor) -> torch.Tensor:
        """P̂⁻¹ @ R for R of shape (…, n, t) (or (n,) vector)."""
        squeeze = R.dim() == 1
        if squeeze:
            R = R[:, None]
        Lt_R = self.L.transpose(-1, -2) @ R  # (…, k, t)
        chol = self.inner_chol.expand(Lt_R.shape[:-2] + self.inner_chol.shape[-2:])
        w = torch.cholesky_solve(Lt_R, chol)
        out = (R - self.L @ w) / _bcast_scalar(self.sigma2)
        return out[:, 0] if squeeze else out

    def matmul(self, M: torch.Tensor) -> torch.Tensor:
        """P̂ @ M (tests / residual checks)."""
        return self.L @ (self.L.transpose(-1, -2) @ M) + _bcast_scalar(self.sigma2) * M

    def logdet(self) -> torch.Tensor:
        n, k = self.L.shape[-2:]
        diag = torch.diagonal(self.inner_chol, dim1=-2, dim2=-1)
        return (n - k) * torch.log(self.sigma2) + 2.0 * torch.sum(torch.log(diag), dim=-1)

    def sample_probes(self, generator: torch.Generator, num: int, n: int) -> torch.Tensor:
        """Draw ``num`` probes with covariance exactly P̂ (Rademacher base,
        shared across any batch dims)."""
        k = self.L.shape[-1]
        g1 = _rademacher(generator, (k, num), self.L.dtype, self.L.device)
        g2 = _rademacher(generator, (n, num), self.L.dtype, self.L.device)
        return self.L @ g1 + torch.sqrt(_bcast_scalar(self.sigma2)) * g2

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


def build_preconditioner(op: LinearOperator, rank: int, *, jitter: float = 1e-8,
                         shard: bool | None = None):
    """Build P̂ from an AddedDiagOperator K̂ = K + σ²I.

    The low-rank factor approximates the *base* kernel K from its rows and
    diagonal; a :class:`BatchDenseOperator` base gets one factor per batch
    element.  The preconditioner is a constant to autograd (built under
    ``no_grad``): gradient estimators stay unbiased for any fixed P̂.

    Under an ambient mesh whose data axes divide n, the generic path builds
    the factor row-sharded (:func:`pivoted_cholesky_sharded`; every rank
    gets the full L).  ``shard=False`` forces the replicated build;
    ``shard=True`` requires the sharded one and raises ``ValueError``
    without such a mesh."""
    if rank <= 0:
        return IdentityPreconditioner(device=op.device)
    if isinstance(op, KroneckerAddedDiagOperator):
        raise NotImplementedError(
            "task-kernel preconditioning for Kronecker multitask operators is "
            "not implemented — the Woodbury solve / logdet assume a scalar σ², "
            "not per-task noise.  Run multitask solves with precond_rank=0 "
            "(MultitaskGP's default settings do)."
        )
    if not isinstance(op, AddedDiagOperator):
        raise TypeError(
            "Preconditioning requires K̂ = K + σ²I (AddedDiagOperator); got "
            f"{type(op).__name__}"
        )
    base = op.base
    with torch.no_grad():
        if isinstance(base, LowRankRootOperator):
            # the root IS the ideal factor (rank ignored): P̂ = K̂ exactly
            sigma2 = torch.as_tensor(op.sigma2, dtype=base.root.dtype, device=base.root.device)
            return PivotedCholeskyPreconditioner.build(base.root.detach(), sigma2.detach())
        if isinstance(base, BatchDenseOperator):
            L = torch.stack([pivoted_cholesky(K.__getitem__, dg, rank, jitter=jitter)
                             for K, dg in zip(base.matrices, base.diagonal())])
        else:
            axes = _precond_shard_axes(base.shape[0]) if shard in (None, True) else ()
            if shard is True and not axes:
                raise ValueError("shard=True but no ambient mesh's data axes evenly divide "
                                 f"n={base.shape[0]}")
            if axes:
                L = pivoted_cholesky_sharded(base, rank, jitter=jitter, axes=axes)
            else:
                L = pivoted_cholesky(base.row, base.diagonal(), rank, jitter=jitter)
        sigma2 = torch.as_tensor(op.sigma2, dtype=L.dtype, device=L.device)
        return PivotedCholeskyPreconditioner.build(L, sigma2.detach())

"""Stochastic Lanczos quadrature for log-determinants (counterpart of
``repro.core.slq``, paper Eq. 5–6).

With probes drawn from N(0, P̂) and the per-probe tridiagonals T̃_i that
mBCG recovers:

    log|P̂⁻¹K̂| ≈ (1/t) Σᵢ (zᵢᵀP̂⁻¹zᵢ) · e₁ᵀ log(T̃_i) e₁
    log|K̂|     = log|P̂⁻¹K̂| + log|P̂|
"""

from __future__ import annotations

import torch

from .mbcg import MBCGResult, tridiag_matrices


def slq_quadrature(T: torch.Tensor, fn=torch.log, eig_floor: float = 1e-10) -> torch.Tensor:
    """e₁ᵀ f(T̃_i) e₁ for a stack of (..., t, p, p) symmetric tridiagonals."""
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp(evals, min=eig_floor)  # PSD guard — tiny negative from roundoff
    first_row = evecs[..., 0, :]  # (..., t, p)   e₁ᵀV
    return torch.sum(first_row**2 * fn(evals), dim=-1)


def logdet_from_mbcg(
    result: MBCGResult, probe_inv_quads: torch.Tensor, precond_logdet: torch.Tensor
) -> torch.Tensor:
    """log|K̂| from an mBCG call on probe columns.

    Args:
      result: mBCG output for the probe RHS block (columns are the zᵢ).
      probe_inv_quads: (t,) values zᵢᵀP̂⁻¹zᵢ.
      precond_logdet: log|P̂| (0 when unpreconditioned).
    """
    quad = slq_quadrature(tridiag_matrices(result))  # (..., t)
    return torch.mean(probe_inv_quads * quad, dim=-1) + precond_logdet

"""Partial pivoted Cholesky decomposition (counterpart of
``repro.core.pivoted_cholesky``, the row/diagonal form).

Computes a rank-k approximation K ≈ L_k L_kᵀ by greedily eliminating the
largest remaining diagonal entry.  Only needs blackbox row access
``row(i) → K[i, :]`` and ``diag() → diag(K)`` — never the full matrix.
Sequential in k by nature (k ≤ ~10), so the reference's ``fori_loop`` is a
Python loop here; the pivot index stays on the device (no host sync).
"""

from __future__ import annotations

from typing import Callable

import torch


def pivoted_cholesky(
    row_fn: Callable[[torch.Tensor], torch.Tensor],
    diag: torch.Tensor,
    rank: int,
    *,
    jitter: float = 1e-8,
) -> torch.Tensor:
    """Rank-``rank`` pivoted Cholesky of the PSD matrix defined by row_fn/diag.

    Returns L (n, k) with K ≈ L @ L.T (columns beyond numerical rank are 0).
    """
    n = diag.shape[0]
    dtype = torch.promote_types(diag.dtype, torch.float32)
    d = diag.to(dtype).clone()
    L = torch.zeros((n, rank), dtype=dtype, device=diag.device)
    picked = torch.zeros((n,), dtype=torch.bool, device=diag.device)
    neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=diag.device)

    for j in range(rank):
        piv = torch.argmax(torch.where(picked, neg_inf, d))
        dpiv = torch.clamp(d[piv], min=0.0)
        ok = dpiv > jitter  # stop producing columns once the residual is exhausted
        sqrt_piv = torch.sqrt(torch.where(ok, dpiv, torch.ones_like(dpiv)))

        row = row_fn(piv).to(dtype)  # K[piv, :]
        # residual row: K[piv,:] - L[piv,:] @ L.T   (columns ≥ j are zero)
        col = (row - L @ L[piv]) / sqrt_piv
        col = torch.where(picked, torch.zeros_like(col), col)  # exact zeros at pivots
        col[piv] = sqrt_piv
        col = torch.where(ok, col, torch.zeros_like(col))

        L[:, j] = col
        d = d - col * col
        picked[piv] = True
    return L


def pivoted_cholesky_dense(K: torch.Tensor, rank: int, **kw) -> torch.Tensor:
    """Convenience wrapper for an explicit matrix (tests / small n)."""
    return pivoted_cholesky(lambda i: K[i], torch.diagonal(K), rank, **kw)

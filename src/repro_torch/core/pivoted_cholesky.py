"""Partial pivoted Cholesky decomposition (counterpart of
``repro.core.pivoted_cholesky``, the row/diagonal form).

Computes a rank-k approximation K ≈ L_k L_kᵀ by greedily eliminating the
largest remaining diagonal entry.  Only needs blackbox row access
``row(i) → K[i, :]`` and ``diag() → diag(K)`` — never the full matrix.
Sequential in k by nature (k ≤ ~10), so the reference's ``fori_loop`` is a
Python loop here; the pivot index stays on the device (no host sync).

:func:`pivoted_cholesky_sharded` row-partitions the O(n·k) per-pivot work
over a mesh's data axes — the last replicated O(n) stage of the solve path:
per pivot an all-gather of the bands' (max, argmax) elects the pivot and a
masked ordered sum broadcasts its L row from the owning band.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed.sharding import (
    all_gather,
    all_gather_rows,
    current_mesh,
    ordered_psum,
    row_band,
)


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


def pivoted_cholesky_sharded(base_op, rank: int, *, jitter: float = 1e-8, mesh=None,
                             axes=("data",)) -> torch.Tensor:
    """Row-sharded rank-``rank`` pivoted Cholesky of a LinearOperator (the
    reference's ``pivoted_cholesky_sharded``).

    Each rank owns the band ``[i·n/S, (i+1)·n/S)`` of (L, d, picked) over
    ``axes`` of ``mesh`` (default: the ambient mesh; none raises
    ``ValueError``, as does an n the shards do not divide).  Per pivot: one
    all-gather of each band's (max, argmax) elects the global pivot — the
    largest diagonal, ties to the lowest global row, as the replicated
    ``argmax``'s first index (bands are in row order and each band's argmax
    takes its first index) — and the owner's L row reaches every rank by a
    masked :func:`~repro_torch.distributed.sharding.ordered_psum` (zeros
    elsewhere, so it arrives exactly).  The pivot row K[piv, :] is
    recomputed on every rank (``base_op.row``) and sliced to the band; the
    O(n·k) updates are the band's own.  Constant under autograd (built
    under ``no_grad``).  Returns the full (n, k) L on every rank."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError("pivoted_cholesky_sharded needs a mesh (the argument or use_mesh)")
    axes = tuple(axes)
    with torch.no_grad():
        diag = base_op.diagonal()
        n = diag.shape[0]
        start, stop = row_band(n, mesh, axes)
        n_loc = stop - start
        dtype = torch.promote_types(diag.dtype, torch.float32)
        dev = diag.device
        d = diag[start:stop].to(dtype).clone()
        L = torch.zeros((n_loc, rank), dtype=dtype, device=dev)
        picked = torch.zeros((n_loc,), dtype=torch.bool, device=dev)
        rows_idx = torch.arange(start, stop, device=dev)
        neg_inf = torch.tensor(-torch.inf, dtype=dtype, device=dev)
        for j in range(rank):
            masked = torch.where(picked, neg_inf, d)
            local = torch.argmax(masked)
            # (value, global row) in f64: both exact, one gather
            pair = torch.stack([masked[local].to(torch.float64), (local + start).to(torch.float64)])
            cand = torch.stack(all_gather(pair, mesh, axes))  # (S, 2), shard order
            win = torch.argmax(cand[:, 0])
            piv = cand[win, 1].to(torch.int64)
            dpiv = torch.clamp(cand[win, 0].to(dtype), min=0.0)
            ok = dpiv > jitter
            sqrt_piv = torch.sqrt(torch.where(ok, dpiv, torch.ones_like(dpiv)))

            row = base_op.row(piv).to(dtype)[start:stop]
            owns = (piv >= start) & (piv < stop)
            L_own = L[torch.clamp(piv - start, 0, n_loc - 1)]
            L_piv = ordered_psum(torch.where(owns, L_own, torch.zeros_like(L_own)), mesh, axes)

            col = (row - L @ L_piv) / sqrt_piv
            col = torch.where(picked, torch.zeros_like(col), col)
            col = torch.where(rows_idx == piv, sqrt_piv, col)
            col = torch.where(ok, col, torch.zeros_like(col))
            L[:, j] = col
            d = d - col * col
            picked = picked | (rows_idx == piv)
        return all_gather_rows(L, mesh, axes, dim=0)

"""Plain PyTorch versions of the fused kernel matmul.

``kernel_matmul_plain`` is the exact function the CUDA kernel computes —
prescaled row/column inputs, a global ``row_offset`` for the σ² diagonal,
a 2-D or batched 3-D right-hand side — with K materialized.  The wrapper in
:mod:`.kernel_matmul` runs it for CPU tensors, and ``chip_smoke.py`` holds
the kernel against it on the card.  ``kernel_matmul_ref`` mirrors the
reference oracle ``repro.kernels.kernel_matmul.ref.kernel_matmul_ref``
(unscaled X and a lengthscale, square K).
"""

from __future__ import annotations

import math

import torch

KERNEL_TYPES = ("rbf", "matern12", "matern32", "matern52")


def apply_stationary(kernel_type: str, d2: torch.Tensor, outputscale) -> torch.Tensor:
    """Squared distances → kernel values, with the kernel's sqrt floor.

    Works in place on ``d2`` (which it consumes) and allocates at most two
    more arrays of its size: at n = 40,000 each is 6.4 GB."""
    if kernel_type == "rbf":
        return d2.mul_(-0.5).exp_().mul_(outputscale)
    a = d2.clamp_(min=1e-20).sqrt_()  # d
    if kernel_type == "matern12":
        return a.neg_().exp_().mul_(outputscale)
    if kernel_type == "matern32":
        a.mul_(math.sqrt(3.0))
        poly = a + 1.0
    elif kernel_type == "matern52":
        a.mul_(math.sqrt(5.0))
        poly = a.square().div_(3.0).add_(a).add_(1.0)
    else:
        raise ValueError(kernel_type)
    return poly.mul_(a.neg_().exp_()).mul_(outputscale)


def _sq_dist(X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """Squared distances from the differences Σ(x − x′)², K-sized memory only.

    Not the kernel's ‖x‖² + ‖x′‖² − 2⟨x, x′⟩ expansion, on purpose: both are
    exactly 0 for coincident points (the kernel computes the norm and the
    inner product with one FMA chain), but an expansion whose norm and
    matmul round differently leaves ~1e-6 there, and Matérn-½'s sqrt turns
    that into ~1e-3 in K — an oracle must not carry that error."""
    d = torch.cdist(X1, X2, compute_mode="donot_use_mm_for_euclid_dist")
    return d * d


def kernel_matmul_plain(
    X1: torch.Tensor,
    X2: torch.Tensor,
    M: torch.Tensor,
    outputscale,
    sigma2,
    row_offset: int = 0,
    *,
    kernel_type: str = "rbf",
) -> torch.Tensor:
    """(K(X1, X2) + σ²·[row_offset + i == j]) @ M, K materialized, in f32.

    X1 (rows, d) and X2 (cols, d) are already divided by the lengthscale;
    M is (cols, t) or (b, cols, t) and the result (rows, t) or (b, rows, t).
    """
    K = apply_stationary(kernel_type, _sq_dist(X1.float(), X2.float()), outputscale)
    # global row row_offset + i meets column j = i + row_offset: K's
    # row_offset-th diagonal
    K.diagonal(int(row_offset)).add_(sigma2)
    return _matmul_rhs(K, M.float())


def _matmul_rhs(K: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """K @ M for a (cols, t) or (b, cols, t) M, without broadcasting K over
    the batch (which could copy it b times): the batch folds into columns."""
    if M.dim() == 2:
        return K @ M
    b, cols, t = M.shape
    out = K @ M.permute(1, 0, 2).reshape(cols, b * t)
    return out.reshape(-1, b, t).permute(1, 0, 2).contiguous()


def kernel_matmul_ref(X, M, lengthscale, outputscale, sigma2, *, kernel_type="rbf"):
    """(K(X,X) + σ²I) @ M, materialized — the correctness reference."""
    Xs = X / lengthscale
    return kernel_matmul_plain(
        Xs, Xs, M, outputscale, sigma2, kernel_type=kernel_type
    )

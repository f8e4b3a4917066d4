"""Plain PyTorch versions of this package's CUDA kernels.

Each is the exact function its kernel computes, with K materialized:

  * ``kernel_matmul_plain`` — B1/B2: prescaled row/column inputs, a global
    ``row_offset`` for the σ² diagonal, a 2-D or batched 3-D right-hand side;
  * ``fused_cg_step_plain`` — B3: one fused CG iteration (the state
    prologue, K̂·D′ and the four reductions) over ``kernel_matmul_plain``;
    ``fused_cg_advance_plain`` and ``fused_cg_product_plain`` are its two
    halves as B3's launches split it (the advance pass, then the product
    with its reductions);
  * ``kernel_matmul_grad_plain`` — the gradient kernel: the VJP of
    ``kernel_matmul_plain`` for its inputs, by ``torch.autograd``;
    ``kernel_matmul_grad_sym_plain`` the same for one X on both sides.

The wrappers in :mod:`.kernel_matmul` run them for CPU tensors, and
``chip_smoke.py`` holds each kernel against its plain version on the card.
``kernel_matmul_ref`` mirrors the reference oracle
``repro.kernels.kernel_matmul.ref.kernel_matmul_ref`` (unscaled X and a
lengthscale, square K).
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


def _stationary(kernel_type: str, d2: torch.Tensor, outputscale) -> torch.Tensor:
    """:func:`apply_stationary` out of place, so autograd can go through it."""
    if kernel_type == "rbf":
        return outputscale * torch.exp(-0.5 * d2)
    a = torch.sqrt(torch.clamp(d2, min=1e-20))
    if kernel_type == "matern12":
        return outputscale * torch.exp(-a)
    if kernel_type == "matern32":
        a = math.sqrt(3.0) * a
        return outputscale * (1.0 + a) * torch.exp(-a)
    if kernel_type == "matern52":
        a = math.sqrt(5.0) * a
        return outputscale * (1.0 + a + a * a / 3.0) * torch.exp(-a)
    raise ValueError(kernel_type)


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


def _advance(R, D, V, alpha, beta, gamma):
    """R′ = R − α∘V and D′ = γ∘R′ + β∘D, per column (α, β, γ: (…, t))."""
    a, b, g = (s[..., None, :] for s in (alpha, beta, gamma))
    R = R - a * V
    return R, g * R + b * D


def cg_reductions(R, D, V) -> torch.Tensor:
    """(…, 4, t): [dᵀV; rᵀr; rᵀV; vᵀV] over the rows, per column."""
    return torch.stack(
        [(D * V).sum(-2), (R * R).sum(-2), (R * V).sum(-2), (V * V).sum(-2)], dim=-2
    )


def fused_cg_step_plain(
    Xs_rows, Xs_cols, U, R, D, V, R_cols, D_cols, V_cols, alpha, beta, gamma,
    outputscale, sigma2, row_offset: int = 0, *, kernel_type: str = "rbf",
):
    """One fused CG iteration (B3) with K materialized.

    The state U, R, D, V is (b, rows, t) — this call's rows — and R_cols,
    D_cols, V_cols the (b, cols, t) column state the product reads (the same
    tensors on a single device); α, β, γ are (b, t).  Applies the pending
    update to both, computes V′ = (K(Xs_rows, Xs_cols) + σ²·[row_offset+i =
    j])·D′ from the column side, and returns (U′, R′, D′, V′, red) with
    red (b, 4, t) = [D′ᵀV′; R′ᵀR′; R′ᵀV′; V′ᵀV′] over this call's rows."""
    U = U + alpha[..., None, :] * D
    R, D = _advance(R, D, V, alpha, beta, gamma)
    _, D_cols = _advance(R_cols, D_cols, V_cols, alpha, beta, gamma)
    V = kernel_matmul_plain(
        Xs_rows, Xs_cols, D_cols, outputscale, sigma2, row_offset, kernel_type=kernel_type
    )
    return U, R, D, V, cg_reductions(R, D, V)


def fused_cg_advance_plain(U, R, D, V, R_cols, D_cols, V_cols, alpha, beta, gamma):
    """B3's advance pass: (U′, R′, D′) of the rows and D′ of the columns,
    each from its own old state (the columns' is the rows' own on one
    device)."""
    U = U + alpha[..., None, :] * D
    R, D = _advance(R, D, V, alpha, beta, gamma)
    _, D_cols = _advance(R_cols, D_cols, V_cols, alpha, beta, gamma)
    return U, R, D, D_cols


def fused_cg_product_plain(
    Xs_rows, Xs_cols, R, D, D_cols, outputscale, sigma2, row_offset: int = 0, *,
    kernel_type: str = "rbf",
):
    """B3's product pass: V′ = (K + σ²·[row_offset+i = j])·D′_cols and the
    reductions [D′ᵀV′; R′ᵀR′; R′ᵀV′; V′ᵀV′] over the rows, from the advance
    pass's R′, D′ (rows) and D′_cols."""
    V = kernel_matmul_plain(
        Xs_rows, Xs_cols, D_cols, outputscale, sigma2, row_offset, kernel_type=kernel_type
    )
    return V, cg_reductions(R, D, V)


def _as_leaf(v, like: torch.Tensor) -> torch.Tensor:
    v = v.detach() if isinstance(v, torch.Tensor) else torch.tensor(float(v))
    return v.to(device=like.device, dtype=torch.float32).reshape(()).requires_grad_()


def kernel_matmul_grad_plain(
    X1, X2, M, C, outputscale, sigma2, row_offset: int = 0, *,
    kernel_type: str = "rbf", chunk_rows: int = 4096,
):
    """The VJP of ``kernel_matmul_plain`` for a cotangent C (rows, t) of its
    output, by ``torch.autograd``: (∂/∂X1, ∂/∂X2, ∂/∂outputscale, ∂/∂σ²) of
    ⟨C, (K(X1, X2) + σ²·[row_offset+i = j])·M⟩ for a 2-D M (cols, t).

    The rows go through in slices of ``chunk_rows`` (the VJP is linear in
    them), so K is materialized a slice at a time and the full size fits
    on the card."""
    X2g = X2.detach().float().requires_grad_()
    s, s2 = _as_leaf(outputscale, X2), _as_leaf(sigma2, X2)
    M, C = M.detach().float(), C.detach().float()
    rows, cols = X1.shape[0], X2.shape[0]
    gX1 = []
    gX2 = torch.zeros_like(X2g)
    gs = torch.zeros((), device=X2.device)
    gs2 = torch.zeros((), device=X2.device)
    for i in range(0, rows, chunk_rows):
        X1g = X1[i : i + chunk_rows].detach().float().requires_grad_()
        # σ² at global row row_offset + i + r = column j: the shifted rows of M
        off = int(row_offset) + i
        diag = torch.zeros((X1g.shape[0], M.shape[1]), device=M.device)
        m = max(0, min(X1g.shape[0], cols - off))
        diag[:m] = M[off : off + m]
        with torch.enable_grad():  # also inside an autograd Function's backward
            out = _stationary(kernel_type, _sq_dist(X1g, X2g), s) @ M + s2 * diag
            g = torch.autograd.grad(out, (X1g, X2g, s, s2), C[i : i + chunk_rows])
        gX1.append(g[0])
        gX2 += g[1]
        gs += g[2]
        gs2 += g[3]
    gX1 = torch.cat(gX1) if gX1 else torch.zeros_like(X1, dtype=torch.float32)
    return gX1, gX2, gs, gs2


def kernel_matmul_grad_sym_plain(
    X, M, C, outputscale, sigma2, *, kernel_type: str = "rbf", chunk_rows: int = 4096,
):
    """The VJP of ``kernel_matmul_plain(X, X, M, …)`` for a cotangent C
    (n, t), one X on both sides, by ``torch.autograd``: (∂/∂X, ∂/∂outputscale,
    ∂/∂σ²) of ⟨C, (K(X, X) + σ²I)·M⟩.  One leaf feeds the rows and the
    columns, so autograd sums both sides' terms; the rows go through in
    slices of ``chunk_rows``."""
    Xg = X.detach().float().requires_grad_()
    s, s2 = _as_leaf(outputscale, X), _as_leaf(sigma2, X)
    M, C = M.detach().float(), C.detach().float()
    gX = torch.zeros_like(Xg)
    gs = torch.zeros((), device=X.device)
    gs2 = torch.zeros((), device=X.device)
    for i in range(0, X.shape[0], chunk_rows):
        with torch.enable_grad():  # also inside an autograd Function's backward
            rows = Xg[i : i + chunk_rows]
            out = _stationary(kernel_type, _sq_dist(rows, Xg), s) @ M + s2 * M[i : i + chunk_rows]
            g = torch.autograd.grad(out, (Xg, s, s2), C[i : i + chunk_rows])
        gX += g[0]
        gs += g[1]
        gs2 += g[2]
    return gX, gs, gs2

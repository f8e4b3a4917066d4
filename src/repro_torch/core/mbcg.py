"""mBCG — modified Batched Conjugate Gradients (paper Algorithm 2).

Counterpart of ``repro.core.mbcg._mbcg_jit``: the unfused path
(``step_plain``) and the fused-launch loop (``_fused_loop``, plain
variant).  One batched matmul against K̂ per iteration yields the
solves U = K̂⁻¹B for every column of B and, for free, the Lanczos
tridiagonal T̃ of each column from the CG coefficients (paper
Observation 3).

As in the reference, termination is a fixed trip count with per-(batch,
column) convergence masking: converged columns stop updating (α = 0) and
their tridiagonal blocks are identity-padded.  The trip count is a Python
loop with no ``.item()`` or other host synchronisation inside it, so the
host enqueues all ``max_iters`` iterations without waiting on the device.

With ``fused_step`` (a :data:`CGStepFn`) each iteration is ONE call that
applies the pending state update, computes K̂·D and the four per-column
reductions — on the GPU one launch of kernel B3.  Only the identity
preconditioner composes with it.  The mixed-precision residual refresh
(``refresh_*``, and the fused loop's refresh variant) is not ported yet:
ROADMAP Queue A step 10.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class MBCGResult(NamedTuple):
    solves: torch.Tensor  # (..., n, t)  — K̂⁻¹B
    tridiag_alpha: torch.Tensor  # (..., t, p)   CG step sizes (0 when inactive)
    tridiag_beta: torch.Tensor  # (..., t, p)   CG momenta
    active_steps: torch.Tensor  # (..., t, p)   bool: column unconverged at step j
    num_iters: torch.Tensor  # (..., t)     iterations actually used per column
    residual_norm: torch.Tensor  # (..., t)     final relative residual ‖r‖/‖b‖
    basis: torch.Tensor | None = None  # (..., n, t, p) preconditioned Lanczos
    # basis (columns z_j/√(r_jᵀz_j)); only with return_basis=True
    num_refreshes: torch.Tensor | None = None  # always None: no refresh path yet
    num_rescues: torch.Tensor | None = None
    num_curvature_skips: torch.Tensor | None = None


#: CGStepFn — the pluggable fused-iteration seam.  Signature::
#:
#:     step(U, R, D, V, alpha, beta, gamma)
#:         -> (U', R', D', V', (dv, rr, rv, vv))
#:
#: with state of shape (..., n, t), per-column scalars (..., t).  The step
#: applies the pending updates  U += α∘D, R −= α∘V, D = γ∘R + β∘D  and then
#: computes V' = K̂ @ D' plus the four reductions dᵀV, rᵀr, rᵀV, vᵀV of the
#: UPDATED state.  It returns new tensors and never writes its inputs.
#: Operators advertise one via ``LinearOperator.fused_cg_step_fn()``;
#: :func:`plain_cg_step` builds it from any matmul (the semantics every
#: fused kernel must match, and the oracle for them).
CGStepFn = Callable


def plain_cg_step(matmul: Callable[[torch.Tensor], torch.Tensor]) -> CGStepFn:
    """:data:`CGStepFn` from a plain blackbox matmul — the torch twin of the
    reference's ``xla_cg_step``: the state recurrence the fused kernel
    implements, in separate torch operations."""

    def step(U, R, D, V, alpha, beta, gamma):
        a = alpha[..., None, :]
        U = U + a * D
        R = R - a * V
        D = gamma[..., None, :] * R + beta[..., None, :] * D
        V = matmul(D).to(R.dtype)
        dv = torch.sum(D * V, dim=-2)
        rr = torch.sum(R * R, dim=-2)
        rv = torch.sum(R * V, dim=-2)
        vv = torch.sum(V * V, dim=-2)
        return U, R, D, V, (dv, rr, rv, vv)

    return step


def _fused_loop(fused_step: CGStepFn, Bc, b_norm, *, tol: float, max_iters: int,
                return_basis: bool):
    """The fused-launch mBCG loop: ONE CGStepFn call per iteration, O(t)
    scalar arithmetic in torch between calls, all on the device.

    State convention: the (α, β, γ) computed after call k are *pending* —
    call k+1's prologue applies them before its matmul, so U/R trail the
    scalars by one rank-1 update, flushed once after the loop.  α uses the
    measured rᵀr of each call; only β rides the pipelined recurrence
    rz′ = rz − 2α·rᵀV + α²·vᵀV (the next call re-measures rᵀr, so the
    recurrence never compounds).

    Returns (U, alphas, betas, actives, basis_cols, res_final)."""
    t = Bc.shape[-1]
    zt = torch.zeros(Bc.shape[:-2] + (t,), dtype=Bc.dtype, device=Bc.device)
    ones_t = torch.ones_like(zt)
    # D = V = 0 are arbitrary: the first call runs with (α=0, β=0, γ=1),
    # whose prologue gives U = 0, R = B, D = R — the textbook CG start
    U, R, D, V = torch.zeros_like(Bc), Bc, torch.zeros_like(Bc), torch.zeros_like(Bc)
    alpha, beta, gamma = zt, zt, ones_t
    active = torch.ones_like(zt, dtype=torch.bool)
    alphas, betas, actives, basis_cols = [], [], [], []
    for _ in range(max_iters):
        U, R, D, V, (dv, rr, rv, vv) = fused_step(U, R, D, V, alpha, beta, gamma)
        rz = torch.clamp(rr, min=0.0)  # identity precond: rᵀz = ‖r‖², measured
        active = active & (torch.sqrt(rz) / b_norm > tol)
        alpha = torch.where(active, _safe_div(rz, dv), zt)
        rz_next = torch.clamp(rz - 2.0 * alpha * rv + alpha * alpha * vv, min=0.0)
        beta = torch.where(active, _safe_div(rz_next, rz), zt)
        gamma = ones_t
        alphas.append(alpha)
        betas.append(beta)
        actives.append(active)
        if return_basis:
            # preconditioned Lanczos vector (identity precond: z_j = r_j)
            basis_cols.append(
                torch.where(active[..., None, :], R * _safe_rsqrt(rz)[..., None, :],
                            torch.zeros_like(R))
            )
    a = alpha[..., None, :]
    U = U + a * D
    R = R - a * V
    res_final = torch.linalg.vector_norm(R, dim=-2) / b_norm
    return U, alphas, betas, actives, basis_cols, res_final


def _safe_div(num, den):
    ok = torch.abs(den) > 1e-30
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(num))


def _safe_rsqrt(x):
    ok = x > 1e-30
    return torch.where(ok, torch.rsqrt(torch.where(ok, x, torch.ones_like(x))), torch.zeros_like(x))


def mbcg(
    matmul: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    *,
    precond_solve: Callable[[torch.Tensor], torch.Tensor] | None = None,
    max_iters: int = 20,
    tol: float = 1e-4,
    return_basis: bool = False,
    refresh_every: int = 0,
    refresh_matmul=None,
    refresh_adaptive: bool = False,
    refresh_max_period: int = 0,
    fused_step=None,
) -> MBCGResult:
    """Solve K̂⁻¹B for all columns (and leading batch dims) of B at once.

    Args:
      matmul: blackbox ``M ↦ K̂ @ M`` for (..., n, t) M.
      B: (n,), (n, t) or (..., n, t) right-hand sides (first column is
        typically y, the rest are probe vectors).
      precond_solve: ``R ↦ P̂⁻¹ R``; identity if None.
      max_iters: fixed trip count p.
      tol: relative-residual convergence threshold per column.
      return_basis: also record the preconditioned Lanczos basis
        W = [z_j/√(r_jᵀz_j)] per column — O(p·n·t) extra memory, used by the
        posterior cache.
      refresh_every, refresh_matmul, refresh_adaptive, refresh_max_period:
        the mixed-precision residual refresh — ROADMAP Queue A step 10.
      fused_step: a :data:`CGStepFn` running one whole CG iteration as a
        single call (on the GPU one B3 launch).  Only the identity
        preconditioner composes with it: passing ``precond_solve`` too is
        an error, never a silent fallback.
    """
    if fused_step is not None and precond_solve is not None:
        raise ValueError(
            "mbcg: fused_step cannot run a precond_solve inside the fused "
            "kernel iteration — the fused CG path supports only the identity "
            "preconditioner.  Set precond_rank=0 (BBMMSettings) to drop the "
            "pivoted-Cholesky preconditioner, or disable fuse_cg to keep it."
        )
    if refresh_every or refresh_matmul is not None or refresh_adaptive or refresh_max_period:
        raise NotImplementedError(
            "mbcg refresh_* (the f32 residual refresh of the mixed-precision "
            "loop, fused or not) is not ported yet: ROADMAP Queue A step 10"
        )
    if precond_solve is None:
        precond_solve = lambda R: R  # noqa: E731

    squeeze = B.dim() == 1
    if squeeze:
        B = B[:, None]
    compute_dtype = torch.promote_types(B.dtype, torch.float32)
    Bc = B.to(compute_dtype)

    b_norm = torch.linalg.vector_norm(Bc, dim=-2)  # (..., t)
    b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)

    if fused_step is not None:
        U, alphas, betas, actives, basis_cols, res_final = _fused_loop(
            fused_step, Bc, b_norm, tol=tol, max_iters=max_iters, return_basis=return_basis
        )
        return _result(B, b_norm, U, alphas, betas, actives, basis_cols, res_final,
                       squeeze, return_basis)

    U = torch.zeros_like(Bc)
    R = Bc  # r = b - K u, u0 = 0
    Z = precond_solve(R).to(compute_dtype)
    D = Z
    rz = torch.sum(R * Z, dim=-2)  # (..., t)
    active = torch.linalg.vector_norm(R, dim=-2) / b_norm > tol

    alphas, betas, actives, basis_cols = [], [], [], []
    for _ in range(max_iters):
        V = matmul(D).to(compute_dtype)
        dv = torch.sum(D * V, dim=-2)
        alpha = torch.where(active, _safe_div(rz, dv), torch.zeros_like(rz))  # frozen columns

        U = U + alpha[..., None, :] * D
        R = R - alpha[..., None, :] * V
        Znew = precond_solve(R).to(compute_dtype)
        rz_new = torch.sum(R * Znew, dim=-2)
        beta = torch.where(active, _safe_div(rz_new, rz), torch.zeros_like(rz))
        D = torch.where(active[..., None, :], Znew + beta[..., None, :] * D, D)

        res = torch.linalg.vector_norm(R, dim=-2) / b_norm
        alphas.append(alpha)
        betas.append(beta)
        actives.append(active)
        if return_basis:
            # preconditioned Lanczos vector of this step: z_j/√(r_jᵀz_j),
            # zeroed once the column has converged (identity-padded T̃ block)
            basis_cols.append(
                torch.where(active[..., None, :], Z * _safe_rsqrt(rz)[..., None, :], torch.zeros_like(Z))
            )
        Z = Znew
        rz = torch.where(active, rz_new, rz)
        active = active & (res > tol)

    res_final = torch.linalg.vector_norm(R, dim=-2) / b_norm
    return _result(B, b_norm, U, alphas, betas, actives, basis_cols, res_final,
                   squeeze, return_basis)


def _result(B, b_norm, U, alphas, betas, actives, basis_cols, res_final, squeeze,
            return_basis) -> MBCGResult:
    """Stack the per-step outputs into the fixed-trip (…, t, p) contract."""
    compute_dtype = U.dtype
    active_steps = torch.stack(actives, dim=-1) if actives else torch.zeros(
        b_norm.shape + (0,), dtype=torch.bool, device=B.device
    )
    num_iters = torch.sum(active_steps, dim=-1)

    solves = U.to(B.dtype)
    basis = torch.stack(basis_cols, dim=-1) if return_basis else None
    if squeeze:
        solves = solves[..., 0]
        if basis is not None:
            basis = basis[..., 0, :]
    empty = torch.zeros(b_norm.shape + (0,), dtype=compute_dtype, device=B.device)
    return MBCGResult(
        solves=solves,
        tridiag_alpha=torch.stack(alphas, dim=-1) if alphas else empty,
        tridiag_beta=torch.stack(betas, dim=-1) if betas else empty,
        active_steps=active_steps,
        num_iters=num_iters,
        residual_norm=res_final,
        basis=basis,
    )


def tridiag_matrices(result: MBCGResult) -> torch.Tensor:
    """Assemble the (..., t, p, p) Lanczos tridiagonals T̃_i from the CG
    coefficients (paper Observation 3 / eq. S5):

        T[0,0]   = 1/α₁
        T[j,j]   = 1/α_{j+1} + β_j/α_j
        T[j,j+1] = T[j+1,j] = √β_{j+1}/α_{j+1}

    Steps where a column had already converged are padded as an identity
    block, which leaves e₁ᵀ f(T̃) e₁ unchanged for the leading block.
    """
    alphas, betas, active = result.tridiag_alpha, result.tridiag_beta, result.active_steps
    p = alphas.shape[-1]
    inv_alpha = _safe_div(torch.ones_like(alphas), alphas)  # 1/α_j, 0 where masked

    pad = torch.nn.functional.pad
    beta_prev = pad(betas[..., :-1], (1, 0))  # β_{j-1}, 0 for j=0
    alpha_prev_inv = pad(inv_alpha[..., :-1], (1, 0))
    diag = inv_alpha + beta_prev * alpha_prev_inv
    diag = torch.where(active, diag, torch.ones_like(diag))  # identity padding

    # offdiag (j, j+1) = sqrt(β_j)/α_j, valid only if step j+1 is active
    off = _safe_div(torch.sqrt(torch.clamp(betas[..., :-1], min=0.0)), alphas[..., :-1])
    off = torch.where(active[..., 1:], off, torch.zeros_like(off))
    off = pad(off, (0, 1))  # (..., t, p)

    eye = torch.eye(p, dtype=diag.dtype, device=diag.device)
    shift = torch.diag(torch.ones(p - 1, dtype=diag.dtype, device=diag.device), 1)
    upper = off[..., None] * shift  # [j, j+1] = off_j
    return diag[..., None] * eye + upper + upper.transpose(-1, -2)

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
preconditioner composes with it.

Mixed precision: when ``matmul`` runs with bf16 operands, the recursively
updated residual drifts from the true residual b − K̂u, so CG can report a
convergence it never reached.  ``refresh_every`` installs the reference's
periodic **f32 residual refresh**: every ``refresh_every`` steps the true
residual is recomputed through ``refresh_matmul`` (the f32 matmul of the
same operator) and the per-column masks are re-derived from it, under
three per-column guards — the curvature guard (a step with dᵀK̂d ≤ 0 or
non-finite is skipped, counted in ``num_curvature_skips``), the momentum
keep / restart (the direction is kept while the recursive residual's
relative drift from the true one stays under
:data:`REFRESH_MOMENTUM_GATE`, else restarted from the preconditioned true
residual), and the best-iterate snapshot (the returned solve is the best
refreshed iterate per column; a non-finite trajectory is pulled back to it,
counted in ``num_rescues``).  ``refresh_adaptive`` doubles the period while
the largest drift stays under :data:`REFRESH_DRIFT_GATE` (capped at
``refresh_max_period``, 0 = uncapped) and snaps back to ``refresh_every``
on a violation.  The fused loop has the same refresh variant: a refresh
step flushes the pending update, refreshes in f32 and re-enters the fused
loop with an (α = 0, β = 1, γ = 0) no-op prologue.

The refresh schedule is host control flow (the f32 matmul is launched only
on refresh steps): the static schedule needs no host synchronisation; the
adaptive one reads the largest drift once per refresh.
"""

from __future__ import annotations

import math
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
    num_refreshes: torch.Tensor | None = None  # () int: in-loop f32 refreshes
    # taken (None without refresh_every)
    num_rescues: torch.Tensor | None = None  # () int: column-steps the
    # non-finite rescue pulled back to the best snapshot (None without refresh)
    num_curvature_skips: torch.Tensor | None = None  # () int: column-steps
    # where the curvature guard saw dᵀK̂d ≤ 0 or non-finite (None without refresh)


# Adaptive refresh: stretch the period only while the recursive residual
# tracks the true one this tightly (largest per-column relative drift).
REFRESH_DRIFT_GATE = 0.1

# Momentum keep / restart at a refresh: the CG direction is kept while the
# recursive residual's relative drift from the true one stays below this;
# past it the direction restarts from the (preconditioned) true residual.
# Shared by the unfused and the fused refresh steps.
REFRESH_MOMENTUM_GATE = 0.25


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


def _int_count(value: int, device) -> torch.Tensor:
    """A host count as a 0-d device tensor (a fill, no copy that would
    synchronise the stream)."""
    return torch.full((), value, dtype=torch.int64, device=device)


class _Refresh:
    """The f32 residual refresh shared by the unfused and the fused loops:
    the schedule (static or adaptive period), the best-iterate snapshot and
    the counters.  ``check`` runs one refresh's guards and returns what the
    loop continues from."""

    def __init__(self, Bc, b_norm, refresh_matmul, *, every, adaptive, max_period, max_iters):
        self.Bc, self.b_norm, self.matmul = Bc, b_norm, refresh_matmul
        self.every, self.adaptive = every, adaptive
        self.cap = max_period if max_period > 0 else max_iters
        self.period, self.since, self.count = every, 0, 0
        zero = torch.zeros((), dtype=torch.int64, device=Bc.device)
        self.rescues, self.curvature_skips = zero, zero
        # the snapshot starts at u = 0, whose residual is b
        self.U_best, self.R_best = torch.zeros_like(Bc), Bc
        self.best_res = torch.linalg.vector_norm(Bc, dim=-2) / b_norm

    def due(self) -> bool:
        """Whether this step refreshes (advances the step counter if not)."""
        if self.since + 1 >= self.period:
            return True
        self.since += 1
        return False

    def skip_curvature(self, active, dv):
        """Count the curvature guard's trips: ~(dv > 0), so that a NaN dv
        (which fails both comparisons) counts too."""
        self.curvature_skips = self.curvature_skips + torch.sum(active & ~(dv > 0))

    def true_residual(self, U):
        """(b − K̂u in f32, its relative norm with a non-finite one as ∞)."""
        Rf = self.Bc - self.matmul(U).to(self.Bc.dtype)
        res_f = torch.linalg.vector_norm(Rf, dim=-2) / self.b_norm
        # NaN hygiene first: an overflowed trajectory reads as ∞, never
        # poisoning the best-so-far bookkeeping through minimum
        return Rf, torch.where(torch.isfinite(res_f), res_f, torch.full_like(res_f, math.inf))

    def check(self, U, Rrec):
        """One refresh at iterate U whose recursive residual is Rrec:
        snapshot the best iterate, rescue a non-finite trajectory from it,
        and measure the drift.  Returns (U, the true residual, the drift)."""
        Rf, res_f = self.true_residual(U)
        better = (res_f < self.best_res)[..., None, :]
        self.U_best = torch.where(better, U, self.U_best)
        self.R_best = torch.where(better, Rf, self.R_best)
        self.best_res = torch.minimum(res_f, self.best_res)
        # only a NON-FINITE trajectory restarts from the best iterate: CG
        # residuals are legitimately non-monotone mid-transient
        pull = torch.isinf(res_f)
        U = torch.where(pull[..., None, :], self.U_best, U)
        Rf = torch.where(pull[..., None, :], self.R_best, Rf)
        self.rescues = self.rescues + torch.sum(pull)
        drift = torch.linalg.vector_norm(Rrec - Rf, dim=-2) / torch.clamp(
            torch.linalg.vector_norm(Rf, dim=-2), min=1e-30
        )
        self.count += 1
        self.since = 0
        if self.adaptive:
            # geometric stretch while the recursion tracks the truth, snap
            # back to the base period on a violation (one host read)
            ok = float(torch.max(drift)) < REFRESH_DRIFT_GATE
            self.period = min(self.period * 2, self.cap) if ok else self.every
        return U, Rf, drift

    def momentum(self, drift, rz_new, rz):
        """β against the refreshed residual where the recursion still tells
        the truth, 0 (a restart) where it has drifted."""
        return torch.where(drift < REFRESH_MOMENTUM_GATE, _safe_div(rz_new, rz),
                           torch.zeros_like(rz))

    def finish(self, U):
        """One last f32 refresh so that progress after the final cycle
        counts; the best refreshed iterate per column is the solve, with its
        TRUE relative residual.  Returns (U, residual, counters)."""
        _, res_t = self.true_residual(U)
        U = torch.where((res_t < self.best_res)[..., None, :], U, self.U_best)
        counters = (_int_count(self.count, U.device), self.rescues, self.curvature_skips)
        return U, torch.minimum(res_t, self.best_res), counters


def _refresh_loop(matmul, precond_solve, Bc, b_norm, refresh: _Refresh, *, tol: float,
                  max_iters: int, return_basis: bool):
    """The unfused mBCG loop with the f32 residual refresh (the reference's
    ``step_refresh``).  Returns (U, alphas, betas, actives, basis_cols,
    res_final, counters)."""
    cd = Bc.dtype
    U = torch.zeros_like(Bc)
    R = Bc
    Z = precond_solve(R).to(cd)
    D = Z
    rz = torch.sum(R * Z, dim=-2)
    active = torch.linalg.vector_norm(R, dim=-2) / b_norm > tol
    alphas, betas, actives, basis_cols = [], [], [], []
    for _ in range(max_iters):
        V = matmul(D).to(cd)
        dv = torch.sum(D * V, dim=-2)
        # curvature guard: bf16 noise can round dᵀK̂d ≤ 0 — skip the step;
        # the direction restarts at the next refresh
        refresh.skip_curvature(active, dv)
        alpha = torch.where((dv > 0) & active, _safe_div(rz, dv), torch.zeros_like(rz))
        # α ≠ 0 guards: a transiently non-finite D or V must not leak NaN
        # into a frozen or skipped column through 0·NaN
        a = alpha[..., None, :]
        U = torch.where(a != 0, U + a * D, U)
        Rrec = torch.where(a != 0, R - a * V, R)
        if refresh.due():
            U, Rn, drift = refresh.check(U, Rrec)
            Zn = precond_solve(Rn).to(cd)
            rz_n = torch.sum(Rn * Zn, dim=-2)
            beta = refresh.momentum(drift, rz_n, rz)
            bD = beta[..., None, :]
            # β = 0 restarts the direction from Zn itself, never 0·D (D
            # may be non-finite)
            Dn = torch.where(bD > 0, Zn + bD * D, Zn)
        else:
            Zn = precond_solve(Rrec).to(cd)
            rz_new = torch.sum(Rrec * Zn, dim=-2)
            beta = torch.where(active, _safe_div(rz_new, rz), torch.zeros_like(rz))
            Dn = torch.where(active[..., None, :], Zn + beta[..., None, :] * D, D)
            Rn, rz_n = Rrec, torch.where(active, rz_new, rz)
        alphas.append(alpha)
        betas.append(beta)
        actives.append(active)
        if return_basis:
            basis_cols.append(
                torch.where(active[..., None, :], Z * _safe_rsqrt(rz)[..., None, :], torch.zeros_like(Z))
            )
        res = torch.linalg.vector_norm(Rn, dim=-2) / b_norm
        # a column whose best refreshed iterate already meets tol freezes
        active = torch.minimum(res, refresh.best_res) > tol
        R, Z, D, rz = Rn, Zn, Dn, rz_n
    U, res_final, counters = refresh.finish(U)
    return U, alphas, betas, actives, basis_cols, res_final, counters


def _fused_refresh_loop(fused_step: CGStepFn, Bc, b_norm, refresh: _Refresh, *, tol: float,
                        max_iters: int, return_basis: bool):
    """The fused-launch loop with the f32 residual refresh (the reference's
    ``fused_refresh``): a refresh step flushes the pending update in f32,
    runs :class:`_Refresh`'s guards and re-enters with the no-op prologue
    (α = 0, β = 1, γ = 0 → D′ = D).  Returns as :func:`_refresh_loop`."""
    zt = torch.zeros(Bc.shape[:-2] + (Bc.shape[-1],), dtype=Bc.dtype, device=Bc.device)
    ones_t = torch.ones_like(zt)
    U, R, D, V = torch.zeros_like(Bc), Bc, torch.zeros_like(Bc), torch.zeros_like(Bc)
    alpha, beta, gamma = zt, zt, ones_t
    alphas, betas, actives, basis_cols = [], [], [], []
    for _ in range(max_iters):
        U, Rk, D, V, (dv, rr, rv, vv) = fused_step(U, R, D, V, alpha, beta, gamma)
        rz = torch.clamp(rr, min=0.0)
        res = torch.sqrt(rz) / b_norm
        # the masks are re-derived from the measured ‖r‖ every launch
        # (columns may reactivate after a refresh exposed a lying residual)
        active = torch.minimum(res, refresh.best_res) > tol
        refresh.skip_curvature(active, dv)
        step_alpha = torch.where((dv > 0) & active, _safe_div(rz, dv), zt)
        if refresh.due():
            a = step_alpha[..., None, :]
            Uf = torch.where(a != 0, U + a * D, U)
            Rrec = torch.where(a != 0, Rk - a * V, Rk)
            U, R, drift = refresh.check(Uf, Rrec)
            step_beta = refresh.momentum(drift, torch.sum(R * R, dim=-2), rz)
            bD = step_beta[..., None, :]
            D = torch.where(bD > 0, R + bD * D, R)  # Z = R: identity preconditioner
            # the state is fully updated: the next launch runs a no-op prologue
            alpha, beta, gamma = zt, ones_t, zt
        else:
            rz_next = torch.clamp(rz - 2.0 * step_alpha * rv + step_alpha * step_alpha * vv, min=0.0)
            step_beta = torch.where(active, _safe_div(rz_next, rz), zt)
            R = Rk
            alpha, beta, gamma = step_alpha, step_beta, ones_t
        alphas.append(step_alpha)
        betas.append(step_beta)
        actives.append(active)
        if return_basis:
            basis_cols.append(
                torch.where(active[..., None, :], Rk * _safe_rsqrt(rz)[..., None, :],
                            torch.zeros_like(Rk))
            )
    # flush the pending update (a no-op after a refresh step)
    a = alpha[..., None, :]
    U = torch.where(a != 0, U + a * D, U)
    U, res_final, counters = refresh.finish(U)
    return U, alphas, betas, actives, basis_cols, res_final, counters


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
      refresh_every: if > 0, every ``refresh_every`` steps recompute the
        TRUE residual b − K̂u through ``refresh_matmul`` and re-derive the
        masks from it, with the guards of the module docstring.
      refresh_matmul: the f32 ``M ↦ K̂ @ M`` of the refresh (defaults to
        ``matmul``).
      refresh_adaptive: double the period while the drift stays under
        :data:`REFRESH_DRIFT_GATE`, back to ``refresh_every`` otherwise.
      refresh_max_period: cap of the adaptive period (0 → ``max_iters``).
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
    if precond_solve is None:
        precond_solve = lambda R: R  # noqa: E731
    if refresh_matmul is None:
        refresh_matmul = matmul

    squeeze = B.dim() == 1
    if squeeze:
        B = B[:, None]
    compute_dtype = torch.promote_types(B.dtype, torch.float32)
    Bc = B.to(compute_dtype)

    b_norm = torch.linalg.vector_norm(Bc, dim=-2)  # (..., t)
    b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm), b_norm)

    if refresh_every:
        refresh = _Refresh(Bc, b_norm, refresh_matmul, every=refresh_every,
                           adaptive=refresh_adaptive, max_period=refresh_max_period,
                           max_iters=max_iters)
        if fused_step is not None:
            out = _fused_refresh_loop(fused_step, Bc, b_norm, refresh, tol=tol,
                                      max_iters=max_iters, return_basis=return_basis)
        else:
            out = _refresh_loop(matmul, precond_solve, Bc, b_norm, refresh, tol=tol,
                                max_iters=max_iters, return_basis=return_basis)
        *out, counters = out
        result = _result(B, b_norm, *out, squeeze, return_basis)
        num_refreshes, num_rescues, num_curvature_skips = counters
        return result._replace(num_refreshes=num_refreshes, num_rescues=num_rescues,
                               num_curvature_skips=num_curvature_skips)

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

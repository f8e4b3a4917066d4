"""The BBMM inference engine (counterpart of ``repro.core.inference``).

A single mBCG call over [y | Z] yields the solve K̂⁻¹y, the probe solves
and the Lanczos tridiagonals for the SLQ log-determinant.  A batched y
(b, n) runs as ONE engine call over (b, n, t + 1): b targets of one
shared K̂ (multi-output; on the GPU the product is B2) or of a batched K̂
(:class:`BatchDenseOperator`, multi-restart), the probes shared across the
batch; the MLL is then (b,).

  * :func:`marginal_log_likelihood` / :func:`inv_quad_logdet` — the
    differentiable MLL: a ``torch.autograd.Function`` whose forward is one
    engine call and whose backward is ONE vector-Jacobian product through
    K̂·[u | K̂⁻¹Z] (on the GPU, the gradient kernel);
  * :func:`build_posterior_cache` runs the engine once and packages every
    reusable solve (K̂⁻¹y, an orthonormal Krylov basis with its
    Rayleigh–Ritz Gram factor, the preconditioner) into a
    :class:`PosteriorCache`; repeated posterior queries then cost O(n·m)
    and no CG;
  * :func:`solve` is the plain preconditioned solve behind uncached
    predictions; :func:`engine_state` the full, non-differentiable state.

Under ``BBMMSettings(fuse_cg=True)`` every mBCG iteration is one fused
step of the operator (on the GPU one B3 launch), where the operator has
one; only ``precond_rank=0`` composes with it.

Under ``BBMMSettings(precision="mixed")`` the CG loop's matmul (or fused
step) takes bf16 operands with f32 accumulation and mBCG refreshes the
residual through the f32 matmul of the same operator every
``cg_refresh_every`` iterations (:func:`_solver_matmuls`).  The
preconditioner, the CG vector arithmetic, the MLL's backward and the
posterior cache's Gram product stay f32.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, NamedTuple

import torch

from . import health
from .health import SolveFailure, SolveHealthWarning, classify_mbcg
from .linear_operator import LinearOperator, replace_tensor_leaves, tensor_leaves
from .mbcg import mbcg
from .precision import precision_compute_dtype, validate_precision
from .preconditioner import IdentityPreconditioner, build_preconditioner
from .slq import logdet_from_mbcg


@dataclasses.dataclass(frozen=True)
class BBMMSettings:
    """Inference-engine knobs — every field of the reference's
    ``BBMMSettings``, with the same defaults.  Fields whose path is not
    ported yet are kept so configurations carry over; the engine refuses
    their non-default values with ``NotImplementedError`` naming the
    ROADMAP Queue A step that brings them."""

    num_probes: int = 10  # t — probe vectors for trace/logdet
    max_cg_iters: int = 20  # p — mBCG iterations
    cg_tol: float = 1e-4  # per-column relative residual target
    precond_rank: int = 5  # k — pivoted-Cholesky rank (0 = off)
    precond_jitter: float = 1e-8
    precision: str = "highest"  # "highest" (all f32) | "mixed" (bf16 operands)
    cg_refresh_every: int = 2  # mixed: f32 residual-refresh period (≥ 1)
    cg_refresh_adaptive: bool = False  # mixed: stretch the period while the drift is small
    cg_refresh_max_period: int = 16  # cap of the stretch (0 = uncapped; floored at the period)
    fuse_cg: bool = False  # one fused launch per CG iteration (step 9)
    on_failure: str = "warn"  # "raise" | "warn" | "degrade" (step 13)
    dense_fallback_max_n: int = 2048  # degradation ladder's dense rung (step 13)
    max_basis_columns: int = 0  # streaming cache compaction (step 14)
    panel_rows: int = 0  # cuda_partitioned: rows per panel (0 = the backend's default)
    panel_budget_bytes: int = 0  # cuda_partitioned: the byte-budget chooser's budget (0 = default)
    dense_direct_max_n: int = 0  # dense-Cholesky routing for tiny n (step 13)

    def __post_init__(self):
        if self.on_failure not in ("raise", "degrade", "warn"):
            raise ValueError(
                f"on_failure must be 'raise', 'degrade' or 'warn', got "
                f"{self.on_failure!r}"
            )


def _fused_step_of(op: LinearOperator, settings: BBMMSettings):
    """The operator's CGStepFn when ``fuse_cg`` asks for it and the operator
    has one; None otherwise (mbcg then runs the unfused loop)."""
    if not settings.fuse_cg:
        return None
    return op.fused_cg_step_fn()


def _solver_matmuls(op: LinearOperator, settings: BBMMSettings):
    """The precision-policy split of one operator into the mBCG inputs:
    (hot-loop matmul, refresh kwargs, fused CG step or None).  "highest" →
    the f32 matmul of the prepared operator (X/ℓ hoisted), no refresh;
    "mixed" → the bf16 matmul of the operator prepared AFTER the dtype
    switch (X/ℓ stored bf16-rounded) for the loop, and the f32 matmul of
    the same operator for the periodic residual refresh.  Under ``fuse_cg``
    the fused step comes from the loop's operator, so mixed mode fuses bf16
    launches while the refresh stays f32."""
    validate_precision(settings.precision)
    solver = op.prepare()
    if settings.precision == "mixed":
        if settings.cg_refresh_every <= 0:
            # the refresh is what keeps mixed mode honest: bf16 CG without it
            # reports convergence the true residual never reached
            raise ValueError(
                "precision='mixed' requires cg_refresh_every >= 1, got "
                f"{settings.cg_refresh_every}"
            )
        mixed = op.with_compute_dtype(precision_compute_dtype(settings.precision)).prepare()
        # 0 means uncapped (mbcg: max_iters); a positive cap is floored at
        # the base period, so adaptivity never shrinks it
        cap = settings.cg_refresh_max_period
        if cap > 0:
            cap = max(cap, settings.cg_refresh_every)
        refresh = {
            "refresh_every": settings.cg_refresh_every,
            "refresh_matmul": solver.matmul,
            "refresh_adaptive": settings.cg_refresh_adaptive,
            "refresh_max_period": cap,
        }
        return mixed.matmul, refresh, _fused_step_of(mixed, settings)
    return solver.matmul, {}, _fused_step_of(solver, settings)


def _precond_solve_arg(precond):
    """mbcg's ``precond_solve``: None for the identity, the Woodbury solve
    otherwise."""
    return None if isinstance(precond, IdentityPreconditioner) else precond.solve


def _run_with_ladder(run, settings: BBMMSettings, *, context):
    """Execute ``run(settings) -> (value, report)`` under the ``on_failure``
    policy: "warn" serves an unhealthy solve with a
    :class:`SolveHealthWarning`, "raise" raises :class:`SolveFailure`.
    Every final report is ``health.record``-ed, stamped with its wall time.
    The "degrade" ladder and ``dense_direct_max_n`` routing are not ported
    yet (ROADMAP Queue A step 13)."""
    if settings.on_failure == "degrade":
        raise NotImplementedError(
            "on_failure='degrade' (the degradation ladder) is not ported yet: "
            "ROADMAP Queue A step 13"
        )
    if settings.dense_direct_max_n > 0:
        raise NotImplementedError(
            "dense_direct_max_n (dense-Cholesky routing for small n) is not "
            "ported yet: ROADMAP Queue A step 13"
        )
    t0 = time.perf_counter()
    value, report = run(settings)
    rung = dataclasses.replace(report.rungs[-1], duration_s=time.perf_counter() - t0)
    report = dataclasses.replace(report, context=context, rungs=report.rungs[:-1] + (rung,))
    health.record(report)
    if not report.healthy:
        if settings.on_failure == "raise":
            raise SolveFailure(report.describe(), report)
        warnings.warn(
            f"unhealthy solve served as-is ({report.describe()})",
            SolveHealthWarning,
            stacklevel=3,
        )
    return value


class PosteriorCache(NamedTuple):
    """Reusable posterior-solve state for cheap repeated predictions.

      * mean queries reuse ``alpha`` — O(n·s), zero CG iterations;
      * variance queries use the Rayleigh–Ritz pair (``basis``,
        ``gram_chol``): k*ᵀK̂⁻¹k* ≈ vᵀG⁻¹v with v = basisᵀk*,
        G = basisᵀK̂basis — O(n·m) per query and conservative.
    """

    alpha: torch.Tensor  # (n,)  K̂⁻¹y
    basis: torch.Tensor | None  # (n, m) orthonormal Krylov cache columns
    gram_chol: torch.Tensor | None  # (m, m) chol(basisᵀ K̂ basis)
    probes: torch.Tensor  # (n, t)  zᵢ
    probe_solves: torch.Tensor  # (n, t) K̂⁻¹zᵢ
    precond: Any  # preconditioner factors (reused by uncached predict solves)
    inv_quad: torch.Tensor  # yᵀK̂⁻¹y
    logdet: torch.Tensor  # log|K̂| estimate (NaN without the variance stage)
    cg_iters: torch.Tensor  # (t+1,) iterations the build used per RHS


def _run_engine(
    op: LinearOperator,
    y: torch.Tensor,
    generator: torch.Generator,
    settings: BBMMSettings,
    *,
    return_basis: bool = False,
    with_logdet: bool = True,
):
    """The shared engine forward pass: preconditioner + probes + ONE mBCG
    over [y | Z] and (optionally) the SLQ log-det.

    Returns (precond, Z, res, probe_solves, logdet) with leading batch dims
    mirroring y's; the probes are drawn once and shared across them."""
    n = y.shape[-1]
    batch_shape = y.shape[:-1]
    precond = build_preconditioner(op, settings.precond_rank, jitter=settings.precond_jitter)
    Z = precond.sample_probes(generator, settings.num_probes, n).to(y.dtype)
    Z = Z.expand(*batch_shape, n, settings.num_probes)
    B = torch.cat([y[..., None], Z], dim=-1)

    matmul, refresh_kwargs, fused_step = _solver_matmuls(op, settings)
    res = mbcg(
        matmul,
        B,
        precond_solve=_precond_solve_arg(precond),
        max_iters=settings.max_cg_iters,
        tol=settings.cg_tol,
        return_basis=return_basis,
        fused_step=fused_step,
        **refresh_kwargs,
    )
    probe_solves = res.solves[..., 1:]

    if with_logdet:
        probe_res = res._replace(
            solves=probe_solves,
            tridiag_alpha=res.tridiag_alpha[..., 1:, :],
            tridiag_beta=res.tridiag_beta[..., 1:, :],
            active_steps=res.active_steps[..., 1:, :],
            num_iters=res.num_iters[..., 1:],
            residual_norm=res.residual_norm[..., 1:],
        )
        logdet = logdet_from_mbcg(probe_res, precond.inv_quad(Z), precond.logdet())
    else:
        logdet = torch.full((), torch.nan, device=y.device)  # mean-only build
    return precond, Z, res, probe_solves, logdet


def build_posterior_cache(
    op: LinearOperator,
    y: torch.Tensor,
    generator: torch.Generator,
    settings: BBMMSettings = BBMMSettings(),
    *,
    variance_cache: bool = True,
) -> PosteriorCache:
    """One engine call → a :class:`PosteriorCache` for O(n·m) queries.

    The cache basis spans every solve the engine produced plus all
    preconditioned-Lanczos directions recovered from the CG run,
    orthonormalized by one QR; its Gram matrix against K̂ costs one extra
    blackbox matmul.  ``variance_cache=False`` skips the Lanczos-basis
    recording, the QR / extra matmul / Cholesky and the SLQ log-det."""
    if y.dim() != 1:
        raise ValueError("posterior cache supports a single problem (y of shape (n,))")
    n = y.shape[0]

    def run(s):
        precond, Z, res, probe_solves, logdet = _run_engine(
            op, y, generator, s, return_basis=variance_cache, with_logdet=variance_cache
        )
        alpha = res.solves[:, 0]
        basis = gram_chol = None
        if variance_cache:
            span = torch.cat([res.solves, res.basis.reshape(n, -1)], dim=-1)
            basis, _ = torch.linalg.qr(span.to(torch.float32))  # (n, m)
            KQ = op.prepare().matmul(basis)  # ONE extra blackbox matmul
            gram = basis.T @ KQ
            gram = 0.5 * (gram + gram.T)
            m = gram.shape[0]
            jitter = 1e-6 * torch.trace(gram) / m
            eye = torch.eye(m, dtype=gram.dtype, device=gram.device)
            gram_chol = torch.linalg.cholesky(gram + jitter * eye)

        cache = PosteriorCache(
            alpha=alpha,
            basis=basis,
            gram_chol=gram_chol,
            probes=Z,
            probe_solves=probe_solves,
            precond=precond,
            inv_quad=torch.dot(y, alpha),
            logdet=logdet,
            cg_iters=res.num_iters,
        )
        return cache, classify_mbcg(res, s.cg_tol, max_iters=s.max_cg_iters)

    return _run_with_ladder(run, settings, context="cache_build")


def cached_mean(cache: PosteriorCache, Kxs: torch.Tensor) -> torch.Tensor:
    """Posterior mean k(X*, X) K̂⁻¹y from the cache — O(n·s), no CG."""
    return Kxs.T @ cache.alpha


def cached_inv_quad(cache: PosteriorCache, Kxs: torch.Tensor) -> torch.Tensor:
    """k*ᵀK̂⁻¹k* per column of Kxs via the Rayleigh–Ritz cache — O(n·m)."""
    if cache.basis is None:
        raise ValueError(
            "cache was built with variance_cache=False; rebuild with "
            "variance_cache=True for variance queries"
        )
    v = cache.basis.T @ Kxs  # (m, s)
    w = torch.cholesky_solve(v, cache.gram_chol)
    return torch.sum(v * w, dim=0)


def solve(op, B, settings: BBMMSettings = BBMMSettings(), *, precond=None):
    """Plain preconditioned solve K̂⁻¹B for B (n,), (n, t) or (b, n, t)
    (prediction-time helper).

    ``precond``: a prebuilt preconditioner (e.g. ``PosteriorCache.precond``)
    to reuse instead of rebuilding the pivoted-Cholesky factors.
    Health-checked per ``settings.on_failure``."""

    def run(s):
        p = precond
        if p is None:
            p = build_preconditioner(op, s.precond_rank, jitter=s.precond_jitter)
        matmul, refresh_kwargs, fused_step = _solver_matmuls(op, s)
        res = mbcg(
            matmul,
            B,
            precond_solve=_precond_solve_arg(p),
            max_iters=s.max_cg_iters,
            tol=s.cg_tol,
            fused_step=fused_step,
            **refresh_kwargs,
        )
        return res.solves, classify_mbcg(res, s.cg_tol, max_iters=s.max_cg_iters)

    return _run_with_ladder(run, settings, context="solve")


class InferenceState(NamedTuple):
    """Every quantity a downstream consumer might want from one engine call."""

    solve_y: torch.Tensor  # (…, n)  K̂⁻¹y
    inv_quad: torch.Tensor  # (…,) yᵀK̂⁻¹y
    logdet: torch.Tensor  # (…,) log|K̂| estimate
    probe_solves: torch.Tensor  # (…, n, t) K̂⁻¹zᵢ
    probes: torch.Tensor  # (…, n, t) zᵢ
    precond_probes: torch.Tensor  # (…, n, t) P̂⁻¹zᵢ
    cg_iters: torch.Tensor  # (…, t+1) iterations per RHS
    residual: torch.Tensor  # (…, t+1) final relative residuals


def _apply_policy(report, settings: BBMMSettings, context: str):
    """Check-only health enforcement (no ladder): record, then raise under
    ``on_failure="raise"`` and warn otherwise.  Used by the differentiable
    MLL, where a retry would desynchronise the backward's residuals;
    training's recovery policy lives in ``fit_gp``."""
    report = dataclasses.replace(report, context=context)
    health.record(report)
    if not report.healthy and settings.on_failure == "raise":
        raise SolveFailure(report.describe(), report)
    if not report.healthy:
        warnings.warn(
            f"unhealthy solve served as-is ({report.describe()})",
            SolveHealthWarning,
            stacklevel=4,
        )
    return report


def _engine_forward(op, y, generator, settings: BBMMSettings, *, context: str = "mll"):
    """Engine forward pass → :class:`InferenceState` (leading dims of a
    batched y (b, n) carried through), health-checked (check-only, see
    :func:`_apply_policy`) and stamped with its wall time."""
    t0 = time.perf_counter()
    precond, Z, res, probe_solves, logdet = _run_engine(op, y, generator, settings)
    u = res.solves[..., 0]
    state = InferenceState(
        solve_y=u,
        inv_quad=torch.sum(y * u, dim=-1),
        logdet=logdet,
        probe_solves=probe_solves,
        probes=Z,
        precond_probes=precond.solve(Z),
        cg_iters=res.num_iters,
        residual=res.residual_norm,
    )
    report = classify_mbcg(res, settings.cg_tol, max_iters=settings.max_cg_iters)
    rung = dataclasses.replace(report.rungs[-1], duration_s=time.perf_counter() - t0)
    _apply_policy(dataclasses.replace(report, rungs=report.rungs[:-1] + (rung,)),
                  settings, context)
    return state


class _InvQuadLogdet(torch.autograd.Function):
    """(yᵀK̂⁻¹y, log|K̂|) with the BBMM gradient estimators; for a batched y
    (b, n) both are (b,).

    Inputs after the non-tensor ones are y and the operator's tensor
    leaves, so autograd reaches every hyperparameter the operator holds.
    Backward: ONE vector-Jacobian product through the blackbox matmul,
    K̂·[u | K̂⁻¹Z] with the cotangent [−g_iq·u | (g_ld/t)·P̂⁻¹Z], which gives
    −g_iq·uᵀ(∂K̂)u + g_ld·(1/t)Σᵢ(P̂⁻¹zᵢ)ᵀ(∂K̂)(K̂⁻¹zᵢ) for every leaf, and
    d_y = 2·g_iq·u.  Batched, the cotangents broadcast over (n, t) per
    batch element, and the product is (b, n, t + 1) — through a shared
    kernel operator on the GPU one B2 launch, its VJP one gradient-kernel
    launch over the batch folded into columns."""

    @staticmethod
    def forward(ctx, op, generator, settings, y, *leaves):
        state = _engine_forward(op, y, generator, settings)
        ctx.op = op
        ctx.save_for_backward(state.solve_y, state.probe_solves, state.precond_probes)
        return state.inv_quad, state.logdet

    @staticmethod
    def backward(ctx, g_iq, g_ld):
        u, probe_solves, pinv_z = ctx.saved_tensors
        t = probe_solves.shape[-1]
        need = ctx.needs_input_grad[4:]
        leaves = [
            leaf.detach().requires_grad_(n) for leaf, n in zip(tensor_leaves(ctx.op), need)
        ]
        grads = [None] * len(leaves)
        wanted = [i for i, n in enumerate(need) if n]
        g_iq, g_ld = g_iq[..., None, None], g_ld[..., None, None]  # over (n, t)
        if wanted:
            rhs = torch.cat([u[..., None], probe_solves], dim=-1)
            cot = torch.cat([-g_iq * u[..., None], (g_ld / t) * pinv_z], dim=-1)
            with torch.enable_grad():
                op = replace_tensor_leaves(ctx.op, leaves)
                out = op.prepare().matmul(rhs)
                got = torch.autograd.grad(
                    out, [leaves[i] for i in wanted], cot, allow_unused=True
                )
            for i, g in zip(wanted, got):
                grads[i] = torch.zeros_like(leaves[i]) if g is None else g
        d_y = 2.0 * g_iq[..., 0] * u if ctx.needs_input_grad[3] else None
        return (None, None, None, d_y, *grads)


def inv_quad_logdet(op: LinearOperator, y: torch.Tensor, generator: torch.Generator,
                    settings: BBMMSettings = BBMMSettings()):
    """Differentiable (yᵀK̂⁻¹y, log|K̂|) for any operator built of
    dataclasses and tensors (its hyperparameters, noise and inputs are
    found by :func:`tensor_leaves`).  ``generator`` draws the probes.  A
    batched y (b, n) returns (b,)-shaped values, still differentiable."""
    return _InvQuadLogdet.apply(op, generator, settings, y, *tensor_leaves(op))


def marginal_log_likelihood(op: LinearOperator, y: torch.Tensor, generator: torch.Generator,
                            settings: BBMMSettings = BBMMSettings()):
    """GP marginal log likelihood −½(yᵀK̂⁻¹y + log|K̂| + n·log 2π) (Eq. 2),
    differentiable w.r.t. every tensor the operator holds and y; (b,) for a
    batched y (b, n)."""
    n = y.shape[-1]
    inv_quad, logdet = inv_quad_logdet(op, y, generator, settings)
    return -0.5 * (inv_quad + logdet + n * math.log(2.0 * math.pi))


def engine_state(op: LinearOperator, y: torch.Tensor, generator: torch.Generator,
                 settings: BBMMSettings = BBMMSettings()) -> InferenceState:
    """Non-differentiable full engine state (prediction paths,
    diagnostics) for y (n,) or a batch (b, n), health-checked check-only
    per ``settings.on_failure``."""
    with torch.no_grad():
        return _engine_forward(op, y, generator, settings, context="engine_state")

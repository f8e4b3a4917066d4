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
    predictions; :func:`engine_state` the full, non-differentiable state;
  * :func:`extend_posterior_cache` updates a cache after appended rows:
    a warm-started solve of the residual correction and the old Krylov
    basis recycled with its Gram factor, compacted by Rayleigh–Ritz
    truncation under ``max_basis_columns`` (:func:`_compact_basis`).

Health (:mod:`repro_torch.core.health`): every non-differentiable entry
point runs under ``settings.on_failure``.  "degrade" walks the
deterministic degradation ladder — ``precision_f32`` → ``unfused`` →
``extend_budget`` → (n ≤ ``dense_fallback_max_n``) ``dense_cholesky`` —
and ``dense_direct_max_n`` routes tiny systems straight to the dense
Cholesky (:func:`_run_with_ladder`).  Every rung re-draws the probes from
the generator state the call began with, as the reference reuses its key.
A kernel that fails to build or launch, or a CUDA error of the card, is
not a rung's failure: it propagates (:func:`_device_fault`).

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
import threading
import time
import warnings
from typing import Any, NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError

from . import health
from .health import RungRecord, SolveFailure, SolveHealthWarning, SolveReport, classify_mbcg
from .linear_operator import LinearOperator, replace_tensor_leaves, tensor_leaves
from .mbcg import mbcg
from .precision import precision_compute_dtype, validate_precision
from .preconditioner import IdentityPreconditioner, build_preconditioner
from .slq import logdet_from_mbcg


@dataclasses.dataclass(frozen=True)
class BBMMSettings:
    """Inference-engine knobs — every field of the reference's
    ``BBMMSettings``, with the same defaults."""

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
    # solve-health policy of the non-differentiable entry points: "raise"
    # (SolveFailure), "warn" (SolveHealthWarning, served as-is) or "degrade"
    # (the ladder; SolveFailure only when it is exhausted)
    on_failure: str = "warn"
    dense_fallback_max_n: int = 2048  # the ladder's dense rung engages for n ≤ this
    # streaming appends: past this many Krylov-basis columns the recycled
    # cache is Rayleigh–Ritz compacted to it (0 = unbounded)
    max_basis_columns: int = 0
    panel_rows: int = 0  # cuda_partitioned: rows per panel (0 = the backend's default)
    panel_budget_bytes: int = 0  # cuda_partitioned: the byte-budget chooser's budget (0 = default)
    dense_direct_max_n: int = 0  # n ≤ this goes straight to dense Cholesky (0 = off)

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


# --- degradation ladder ----------------------------------------------------


def _escalation_ladder(settings: BBMMSettings):
    """The deterministic rung sequence for ``on_failure='degrade'``.

    Escalation is CUMULATIVE — each rung keeps every earlier replacement —
    and ordered cheapest-first:

      1. ``precision_f32``  — mixed → highest;
      2. ``unfused``        — drop the fused CG step (also what re-enables
         preconditioning);
      3. ``extend_budget``  — double ``max_cg_iters`` and install the
         pivoted-Cholesky preconditioner if it was off;
      4. (terminal, built by the caller) small-n dense Cholesky.

    Rungs that change nothing (already f32, already unfused) are skipped."""
    rungs = []
    s = settings
    if s.precision != "highest":
        s = dataclasses.replace(s, precision="highest")
        rungs.append(("precision_f32", s))
    if s.fuse_cg:
        s = dataclasses.replace(s, fuse_cg=False)
        rungs.append(("unfused", s))
    s = dataclasses.replace(
        s,
        max_cg_iters=2 * s.max_cg_iters,
        precond_rank=s.precond_rank if s.precond_rank > 0 else 5,
        fuse_cg=False,  # a non-identity preconditioner cannot fuse
    )
    rungs.append(("extend_budget", s))
    return rungs


def _apply_policy(report, settings: BBMMSettings, context: str):
    """Check-only health enforcement (no ladder): record, then raise under
    ``on_failure="raise"`` and warn otherwise.  Used by the differentiable
    MLL, where a retry would desynchronise the backward's residuals, and
    for a healthy or non-degrading first rung; training's recovery policy
    lives in ``fit_gp``."""
    report = dataclasses.replace(report, context=context)
    health.record(report)
    if not report.healthy and settings.on_failure == "raise":
        raise SolveFailure(report.describe(), report)
    if not report.healthy:
        warnings.warn(
            f"unhealthy solve served as-is ({report.describe()}); set "
            "BBMMSettings(on_failure='degrade') for automatic recovery",
            SolveHealthWarning,
            stacklevel=4,
        )
    return report


def _stamp_last_rung(report, duration_s: float):
    """Attach wall time to the most recent rung attempt of a report."""
    rungs = list(report.rungs)
    rungs[-1] = dataclasses.replace(rungs[-1], duration_s=duration_s)
    return dataclasses.replace(report, rungs=tuple(rungs))


def _device_fault(e: BaseException) -> bool:
    """A fault of the kernels or of the card, which no rung can heal: a
    kernel that failed to build or whose launch returned a CUDA error (the
    wrappers raise :class:`KernelBuildError` / :class:`KernelLaunchError`),
    or a CUDA error torch reports (after one, every later launch fails
    too).  Anything else a rung raises — a preconditioner it cannot build,
    a factorization that fails — is that rung's failure."""
    if isinstance(e, (KernelBuildError, KernelLaunchError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


def _run_with_ladder(run, settings: BBMMSettings, *, context, n, dense_fn=None):
    """Execute ``run(settings) -> (value, report)`` under the
    ``on_failure`` policy, walking the degradation ladder when asked.

    Every rung attempt — healed, still unhealthy, or errored — lands in
    ``SolveReport.rungs``, stamped with its wall time.  ``dense_fn() ->
    (value, RungRecord)`` is the terminal rung, engaged only for
    ``n <= settings.dense_fallback_max_n``; ``dense_direct_max_n`` runs it
    FIRST for tiny systems (a "dense_direct" rung), the iterative engine
    only if it comes back unhealthy.  When a trace is active the walk is a
    ``"solve"`` span with one ``"rung:<name>"`` child per attempt.  A
    device fault (:func:`_device_fault`) in any rung propagates."""
    with obs.span("solve", context=context, n=n):
        return _ladder_walk(run, settings, context=context, n=n, dense_fn=dense_fn)


def _ladder_walk(run, settings: BBMMSettings, *, context, n, dense_fn=None):
    if dense_fn is not None and 0 < n <= settings.dense_direct_max_n:
        t_dd = time.perf_counter()
        with obs.span("rung:dense_direct", context=context):
            value, rec = dense_fn()
        rec = dataclasses.replace(rec, rung="dense_direct", duration_s=time.perf_counter() - t_dd)
        if rec.status == health.CONVERGED:
            health.record(SolveReport(
                status=health.CONVERGED,
                residual_norm=rec.residual_norm or 0.0,
                tol=settings.cg_tol,
                num_iters=0,
                max_iters=settings.max_cg_iters,
                context=context,
                rungs=(rec,),
            ))
            return value
        warnings.warn(
            f"dense_direct routing (n={n} <= {settings.dense_direct_max_n}) "
            "produced an unhealthy solve; running the iterative engine",
            SolveHealthWarning,
            stacklevel=4,
        )
    t_init = time.perf_counter()
    with obs.span("rung:initial", context=context):
        value, report = run(settings)
    report = _stamp_last_rung(dataclasses.replace(report, context=context),
                              time.perf_counter() - t_init)
    if report.healthy or settings.on_failure != "degrade":
        _apply_policy(report, settings, context)
        return value

    rungs = list(report.rungs)
    for name, s in _escalation_ladder(settings):
        t_rung = time.perf_counter()
        try:
            with obs.span(f"rung:{name}", context=context):
                value2, rep2 = run(s)
        except Exception as e:
            if _device_fault(e):
                raise
            # the rung is structurally unavailable: record it, go on
            rungs.append(RungRecord(rung=name, status=None, error=repr(e),
                                    duration_s=time.perf_counter() - t_rung))
            continue
        rungs.append(RungRecord(rung=name, status=rep2.status, residual_norm=rep2.residual_norm,
                                num_iters=rep2.num_iters,
                                duration_s=time.perf_counter() - t_rung))
        if rep2.healthy:
            final = dataclasses.replace(rep2, context=context, rungs=tuple(rungs))
            health.record(final)
            warnings.warn(f"solve degraded but healed: {final.describe()}",
                          SolveHealthWarning, stacklevel=4)
            return value2
        report = dataclasses.replace(rep2, context=context)

    if dense_fn is not None and n <= settings.dense_fallback_max_n:
        t_dense = time.perf_counter()
        try:
            with obs.span("rung:dense_cholesky", context=context):
                value3, rec = dense_fn()
        except Exception as e:
            if _device_fault(e):
                raise
            rungs.append(RungRecord(rung="dense_cholesky", status=None, error=repr(e),
                                    duration_s=time.perf_counter() - t_dense))
        else:
            rec = dataclasses.replace(rec, duration_s=time.perf_counter() - t_dense)
            rungs.append(rec)
            if rec.status == health.CONVERGED:
                final = dataclasses.replace(
                    report,
                    status=health.CONVERGED,
                    residual_norm=rec.residual_norm if rec.residual_norm is not None else 0.0,
                    num_iters=0,
                    context=context,
                    rungs=tuple(rungs),
                )
                health.record(final)
                warnings.warn(f"solve degraded to dense Cholesky: {final.describe()}",
                              SolveHealthWarning, stacklevel=4)
                return value3

    final = dataclasses.replace(report, rungs=tuple(rungs))
    health.record(final)
    raise SolveFailure(f"degradation ladder exhausted: {final.describe()}", final)


def _dense_chol(op: LinearOperator, n: int):
    """Materialize + factor the operator for the dense rungs.

    Raises SolveFailure when the factorization itself is unhealthy (a
    genuinely non-PSD system has no healthy answer on any rung)."""
    Kd = op.prepare().to_dense().to(torch.float32)
    L, info = torch.linalg.cholesky_ex(Kd)
    if int(info) != 0 or not bool(torch.isfinite(L).all()):
        raise SolveFailure(
            f"dense Cholesky fallback failed: operator (n={n}) is not positive definite"
        )
    return Kd, L


def _dense_rung_record(Kd, rhs, X):
    res = float(torch.max(
        torch.linalg.vector_norm(rhs - Kd @ X, dim=-2)
        / torch.clamp(torch.linalg.vector_norm(rhs, dim=-2), min=1e-30)
    ))
    status = health.CONVERGED if math.isfinite(res) else health.NON_FINITE
    return RungRecord(rung="dense_cholesky", status=status, residual_norm=res, num_iters=0)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of A, all NaN where A is not positive definite (as
    the reference's), with no host synchronisation: an unhealthy solve's
    NaN flows into its cache and its report instead of raising."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info[..., None, None] == 0, L, torch.full_like(L, math.nan))


#: serialises the engine's QR factorizations across threads: cuSOLVER's
#: geqrf (``torch.linalg.qr`` on CUDA) called from two threads at once fails
#: with CUSOLVER_STATUS_INTERNAL_ERROR (a session's refresher building while
#: an append runs); its other dense factorizations run concurrently cleanly
_QR_LOCK = threading.Lock()


def _qr(A: torch.Tensor) -> torch.Tensor:
    """The orthonormal factor Q of A's reduced QR."""
    with _QR_LOCK:
        return torch.linalg.qr(A)[0]


#: a fresh Krylov direction whose part outside the recycled span is below
#: this fraction of the largest such part is dropped (f32 rounding leaves
#: ~1e-7 in directions a converged CG run never explored)
NEW_DIRECTION_TOL = 1e-3


def _new_directions(F: torch.Tensor, B: torch.Tensor, q_max: int) -> torch.Tensor:
    """An orthonormal basis (at most ``q_max`` columns) of the part of
    span(F) outside span(B), B orthonormal.

    The reference orthonormalizes the projected block by QR, which turns a
    column that adds no direction — a zero Lanczos column of a CG run that
    converged early, or one inside the recycled span — into an arbitrary
    unit vector not orthogonal to span(B); [B | N] then goes rank-deficient
    and after a second such append its Gram is singular (the reference's
    cache serves NaN variances).  Here the significant directions of the
    projected block, each column scaled by its norm before projection, come
    from the eigendecomposition of its small Gram, and are projected and
    orthonormalised once more ("twice is enough"); a well-posed block keeps
    its span.  A non-finite block (an
    unhealthy rung's) gives ``q_max`` NaN columns, as the reference's QR
    would.  One host synchronisation: the number of directions kept."""
    P = F - B @ (B.T @ F)
    if not bool(torch.isfinite(P).all()):
        return torch.full((P.shape[0], min(q_max, P.shape[1])), math.nan, device=P.device)
    # each column as the fraction of it that lies outside span(B)
    P = P / torch.clamp(torch.linalg.vector_norm(F, dim=0), min=1e-30)
    lam, V = torch.linalg.eigh(P.T @ P)  # ascending
    k = min(int((lam > NEW_DIRECTION_TOL**2 * lam[-1]).sum()), q_max)
    N = P @ (V[:, -k:] / torch.sqrt(lam[-k:])) if k else P[:, :0]
    return _qr(N - B @ (B.T @ N))


def _rewinder(generator: torch.Generator):
    """A callable that puts ``generator`` back to its state now: each
    ladder rung draws the same probes, as the reference reuses its key."""
    state = generator.get_state()
    return lambda: generator.set_state(state)


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
    recording, the QR / extra matmul / Cholesky and the SLQ log-det.
    Health-checked per ``settings.on_failure`` (the ladder's terminal rung:
    :func:`_dense_cache`)."""
    if y.dim() != 1:
        raise ValueError("posterior cache supports a single problem (y of shape (n,))")
    n = y.shape[0]
    rewind = _rewinder(generator)

    def run(s):
        rewind()
        precond, Z, res, probe_solves, logdet = _run_engine(
            op, y, generator, s, return_basis=variance_cache, with_logdet=variance_cache
        )
        alpha = res.solves[:, 0]
        basis = gram_chol = None
        if variance_cache:
            span = torch.cat([res.solves, res.basis.reshape(n, -1)], dim=-1)
            basis = _qr(span.to(torch.float32))  # (n, m)
            KQ = op.prepare().matmul(basis)  # ONE extra blackbox matmul
            gram = basis.T @ KQ
            gram = 0.5 * (gram + gram.T)
            m = gram.shape[0]
            jitter = 1e-6 * torch.trace(gram) / m
            eye = torch.eye(m, dtype=gram.dtype, device=gram.device)
            gram_chol = _cholesky(gram + jitter * eye)

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

    def dense():
        rewind()
        return _dense_cache(op, y, generator, settings, variance_cache=variance_cache)

    return _run_with_ladder(run, settings, context="cache_build", n=n, dense_fn=dense)


def _dense_cache(op, y, generator, settings, *, variance_cache):
    """Terminal ladder rung for the posterior cache: exact dense state.

    ``basis=eye(n)`` with ``gram_chol=chol(K̂)`` makes ``cached_inv_quad``
    compute the EXACT k*ᵀK̂⁻¹k* — the served variance contract (never
    undershooting) holds trivially."""
    n = y.shape[-1]
    Kd, L = _dense_chol(op, n)
    t = settings.num_probes
    Z = IdentityPreconditioner(device=y.device).sample_probes(generator, t, n).to(y.dtype)
    rhs = torch.cat([y[:, None], Z], dim=-1)
    X = torch.linalg.solve(Kd, rhs)
    alpha = X[:, 0]
    cache = PosteriorCache(
        alpha=alpha,
        basis=torch.eye(n, dtype=torch.float32, device=y.device) if variance_cache else None,
        gram_chol=L if variance_cache else None,
        probes=Z,
        probe_solves=X[:, 1:],
        precond=IdentityPreconditioner(device=y.device),
        inv_quad=torch.dot(y, alpha),
        logdet=2.0 * torch.sum(torch.log(torch.diagonal(L))),
        cg_iters=torch.zeros(t + 1, dtype=torch.int64, device=y.device),
    )
    return cache, _dense_rung_record(Kd, rhs, X)


def _compact_basis(basis: torch.Tensor, gram: torch.Tensor, max_m: int):
    """Rayleigh–Ritz truncation of a Krylov variance cache to ``max_m``
    columns: diagonalize the small Gram G = QᵀK̂Q = W Λ Wᵀ, keep the top-m
    eigendirections, rotate the basis into them.

    The rotated basis Q·W_m stays orthonormal, its Gram is exactly
    diag(Λ_m), and its span is a SUBSPACE of the original — so the
    Galerkin inverse-quad can only shrink and the served posterior
    variance stays conservative at any budget; only tightness is traded
    for the fixed memory.  A non-finite Gram (an unhealthy rung's) gives
    an all-NaN result, as the reference's, without a host synchronisation
    (torch's ``eigh`` refuses NaN input, so it factors a zeroed copy)."""
    m = gram.shape[0]
    bad = ~torch.isfinite(gram).all()
    lam, W = torch.linalg.eigh(torch.where(bad, torch.zeros_like(gram), gram))  # ascending
    nan = torch.full((), math.nan, dtype=gram.dtype, device=gram.device)
    keep = torch.where(bad, nan, W[:, m - max_m:])
    lam = torch.where(bad, nan, lam[m - max_m:])
    # eigh of the jittered PSD Gram: floor tiny/negative Ritz values at the
    # same relative jitter scale the full build uses
    lam = torch.maximum(lam, 1e-6 * torch.trace(gram) / m)
    return basis @ keep, torch.diag(torch.sqrt(lam))


def extend_posterior_cache(
    op: LinearOperator,
    y: torch.Tensor,
    cache: PosteriorCache,
    settings: BBMMSettings = BBMMSettings(),
) -> PosteriorCache:
    """Incremental PosteriorCache update after data rows were appended.

    ``op`` / ``y`` are the FULL updated system (old n rows plus k appended
    ones); ``cache`` is the cache built for the first n rows.  Instead of
    re-running the (t+1)-column engine block from a cold start, the update
    recycles what the old cache knows:

      * **warm-started solve** — the old ``alpha`` (zero-padded to n+k) is
        the initial iterate; one single-column mBCG solves the residual
        correction K̂'δ = y' − K̂'u₀ to the SAME final tolerance (``tol``
        rescaled by ‖y'‖/‖r₀‖, so the target stays ‖y' − K̂'u‖ ≤
        cg_tol·‖y'‖);
      * **Krylov-basis recycling** — the old orthonormal basis, zero-padded
        to the new rows, stays orthonormal, and its Gram factor is reused
        as is (the old n×n block of K̂' is the old K̂); only the genuinely
        new directions (the new alpha + the δ-run's Lanczos vectors,
        projected against the recycled span and QR'd) go through the
        blackbox matmul — O(n²·q) for q ≈ p+1 new columns.  The Galerkin
        inverse-quad is conservative for any full-rank basis, so staleness
        of the recycled directions costs tightness, never correctness.

    The basis grows by ≤ max_cg_iters+1 columns per update; past
    ``settings.max_basis_columns`` it is compacted (:func:`_compact_basis`),
    and the serving layer's ``max_staleness`` forces a full rebuild.
    ``logdet`` is NaN on the updated cache and ``probes`` /
    ``probe_solves`` are the old columns zero-padded (stale diagnostics,
    unused by queries).  On the GPU: one B1 launch for the residual, one
    per CG iteration (or one B3), one for the q new columns.
    """
    if y.dim() != 1:
        raise ValueError("posterior cache supports a single problem (y of shape (n,))")
    n = y.shape[0]
    n_old = cache.alpha.shape[0]
    k = n - n_old
    if k <= 0:
        raise ValueError(
            f"extend_posterior_cache needs appended rows (cache n={n_old}, y n={n})"
        )
    variance_cache = cache.basis is not None

    def run(s):
        return _extend_cache_once(op, y, cache, s, k=k, variance_cache=variance_cache)

    def dense():
        generator = torch.Generator(device=y.device)
        generator.manual_seed(0)
        dcache, rec = _dense_cache(op, y, generator, settings, variance_cache=variance_cache)
        # keep the recycled probe diagnostics (stale but shape-stable, like
        # the normal extend path) rather than the fresh dense draws
        dcache = dcache._replace(
            probes=torch.nn.functional.pad(cache.probes, (0, 0, 0, k)),
            probe_solves=torch.nn.functional.pad(cache.probe_solves, (0, 0, 0, k)),
            cg_iters=torch.zeros(1, dtype=torch.int64, device=y.device),
        )
        return dcache, rec

    return _run_with_ladder(run, settings, context="cache_extend", n=n, dense_fn=dense)


def _extend_cache_once(op, y, cache, settings: BBMMSettings, *, k: int, variance_cache: bool):
    n = y.shape[0]
    pad_rows = (0, 0, 0, k)
    precond = build_preconditioner(op, settings.precond_rank, jitter=settings.precond_jitter)
    matmul, refresh_kwargs, fused_step = _solver_matmuls(op, settings)
    solver = op.prepare()

    u0 = torch.nn.functional.pad(cache.alpha, (0, k))
    r0 = y - solver.matmul(u0[:, None])[:, 0]  # f32 true residual
    # mbcg's tol is relative to ‖r0‖; rescale so the TARGET stays
    # ‖y − K̂u‖ ≤ cg_tol·‖y‖, the full build's contract
    tol_eff = settings.cg_tol * torch.linalg.vector_norm(y) / torch.clamp(
        torch.linalg.vector_norm(r0), min=1e-30)

    res = mbcg(
        matmul,
        r0[:, None],
        precond_solve=_precond_solve_arg(precond),
        max_iters=settings.max_cg_iters,
        tol=tol_eff,
        return_basis=variance_cache,
        fused_step=fused_step,
        **refresh_kwargs,
    )
    alpha = u0 + res.solves[:, 0]

    basis = gram_chol = None
    if variance_cache:
        B_old = torch.nn.functional.pad(cache.basis, pad_rows)  # still orthonormal
        m_old = B_old.shape[1]
        # at most n orthonormal columns: past that the Gram goes singular,
        # so the fresh block is capped (q_cap == 0: the recycled span is
        # already full-dimensional and the old factor serves as is)
        q_cap = max(n - m_old, 0)
        if q_cap == 0:
            basis, gram_chol = B_old, cache.gram_chol
        else:
            fresh = torch.cat([alpha[:, None], res.basis.reshape(n, -1)], dim=-1).to(torch.float32)
            N = _new_directions(fresh, B_old, q_cap)  # (n, q)
            KN = solver.matmul(N)  # the blackbox matmul on the q new columns only
            # the old Gram block recycled exactly (CᵀC includes its jitter;
            # overstating the Gram only makes the variance more conservative)
            top = cache.gram_chol @ cache.gram_chol.T
            cross = B_old.T @ KN  # (m, q)
            low = N.T @ KN
            low = 0.5 * (low + low.T)
            q = low.shape[0]
            jitter = 1e-6 * torch.trace(low) / q
            eye = torch.eye(q, dtype=low.dtype, device=low.device)
            gram = torch.cat([torch.cat([top, cross], dim=1),
                              torch.cat([cross.T, low + jitter * eye], dim=1)], dim=0)
            basis = torch.cat([B_old, N], dim=-1)
            gram_chol = _cholesky(gram)
        # under a serving memory budget the recycled basis stops growing:
        # Rayleigh–Ritz truncation to the top-m eigendirections
        max_m = settings.max_basis_columns
        if max_m and basis.shape[1] > max_m:
            gram_full = gram_chol @ gram_chol.T
            basis, gram_chol = _compact_basis(basis.to(torch.float32),
                                              gram_full.to(torch.float32), max_m)

    new_cache = PosteriorCache(
        alpha=alpha,
        basis=basis,
        gram_chol=gram_chol,
        probes=torch.nn.functional.pad(cache.probes, pad_rows),
        probe_solves=torch.nn.functional.pad(cache.probe_solves, pad_rows),
        precond=precond,
        inv_quad=torch.dot(y, alpha),
        logdet=torch.full((), math.nan, device=y.device),
        cg_iters=res.num_iters,
    )
    # classified against the tolerance in force (tol_eff) and on the FULL
    # warm-started iterate, which is what callers consume
    report = classify_mbcg(res, tol_eff, max_iters=settings.max_cg_iters, solution=alpha)
    return new_cache, report


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
    to reuse instead of rebuilding the pivoted-Cholesky factors; ladder
    rungs rebuild it for their own settings.  Health-checked per
    ``settings.on_failure``."""
    n = B.shape[-2] if B.dim() > 1 else B.shape[-1]

    def run(s):
        p = precond
        if p is None or s is not settings:
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

    def dense():
        Kd, _ = _dense_chol(op, n)
        rhs = B[..., None] if B.dim() == 1 else B
        X = torch.linalg.solve(Kd, rhs)
        return (X[..., 0] if B.dim() == 1 else X), _dense_rung_record(Kd, rhs, X)

    return _run_with_ladder(run, settings, context="solve", n=n, dense_fn=dense)


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


def _engine_forward_report(op, y, generator, settings: BBMMSettings):
    """Engine forward pass → (:class:`InferenceState`, its health report);
    leading dims of a batched y (b, n) carried through."""
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
    return state, classify_mbcg(res, settings.cg_tol, max_iters=settings.max_cg_iters)


def _engine_forward(op, y, generator, settings: BBMMSettings, *, context: str = "mll"):
    """The differentiable MLL's forward: health-checked check-only (see
    :func:`_apply_policy`) and stamped with its wall time."""
    t0 = time.perf_counter()
    with obs.span("engine_forward", context=context):
        state, report = _engine_forward_report(op, y, generator, settings)
    _apply_policy(_stamp_last_rung(report, time.perf_counter() - t0), settings, context)
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
    diagnostics) for y (n,) or a batch (b, n).  Health-checked per
    ``settings.on_failure`` — under ``"degrade"`` an unhealthy run walks
    the ladder down to a small-n dense Cholesky before giving up."""
    n = y.shape[-1]
    rewind = _rewinder(generator)

    def run(s):
        rewind()
        return _engine_forward_report(op, y, generator, s)

    def dense():
        rewind()
        Kd, L = _dense_chol(op, n)
        t = settings.num_probes
        Z = IdentityPreconditioner(device=y.device).sample_probes(generator, t, n).to(y.dtype)
        Z = Z.expand(*y.shape[:-1], n, t)
        rhs = torch.cat([y[..., None], Z], dim=-1)
        X = torch.linalg.solve(Kd, rhs)
        u = X[..., 0]
        state = InferenceState(
            solve_y=u,
            inv_quad=torch.sum(y * u, dim=-1),
            logdet=(2.0 * torch.sum(torch.log(torch.diagonal(L)))).expand(y.shape[:-1]),
            probe_solves=X[..., 1:],
            probes=Z,
            precond_probes=Z,
            cg_iters=torch.zeros(y.shape[:-1] + (t + 1,), dtype=torch.int64, device=y.device),
            residual=torch.linalg.vector_norm(rhs - Kd @ X, dim=-2)
            / torch.clamp(torch.linalg.vector_norm(rhs, dim=-2), min=1e-30),
        )
        return state, _dense_rung_record(Kd, rhs, X)

    with torch.no_grad():
        return _run_with_ladder(run, settings, context="engine_state", n=n, dense_fn=dense)

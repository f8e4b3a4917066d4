"""Public wrappers for the fused kernel matmul (counterpart of
``repro.kernels.kernel_matmul.ops``).

  * :func:`prescale_inputs` — the once-per-solve work, X/ℓ (ARD broadcasts a
    (d,) ℓ).  ``KernelOperator.prepare()`` hoists it out of the CG loop.
  * :func:`fused_kernel_matmul_prescaled` / :func:`fused_kernel_matmul` —
    the single-device entry points.
  * :func:`stationary_kernel_type` — a kernel object's kernel-type code.
  * :func:`fused_cg_step` / :func:`fused_cg_step_prescaled` — one fused mBCG
    iteration (B3), the second the single-device
    :data:`repro_torch.core.mbcg.CGStepFn`.
  * :func:`choose_panel_rows` and :func:`cuda_panel_rows` — the partitioned
    path's panel height (the reference's byte-budget chooser; the card's
    default for the CUDA kernels, from its SM count);
  * :func:`panel_matmul_prescaled`, :func:`panel_vjp_prescaled` and
    :func:`panel_fused_cg_step_prescaled` — K̂·M, its vector-Jacobian
    product and one fused CG iteration streamed one row-panel at a time:
    one B1/B2, gradient-kernel or B3 launch per panel with the panel's
    ``row_offset``; :func:`band_matmul_prescaled` and
    :func:`band_vjp_prescaled` the same over one row band;
  * :func:`sharded_kernel_matmul_prescaled` / :func:`sharded_kernel_matmul`
    (differentiable through :class:`ShardedMatmulFn`) and
    :func:`sharded_fused_cg_step_prescaled` — the row-sharded product and
    fused step over a :class:`repro_torch.distributed.Mesh`: each rank
    launches the same kernels on its own band at the band's
    ``row_offset``, and the bands are all-gathered.

A 2-D product goes through :class:`.kernel_matmul.KernelMatmulFn` (or
:class:`.kernel_matmul.SymKernelMatmulFn` when one X is on both sides), a
batched one (B2) through :class:`.kernel_matmul.BatchedKernelMatmulFn`, so
both are differentiable in X (hence the lengthscale), the outputscale and
σ², with the gradient kernel as their backward.

The reference's 128-lane feature padding and M lane padding are TPU layout
artifacts and are dropped: zero feature columns do not change distances,
and the CUDA kernels mask every ragged edge themselves.  Its ``interpret`` and
``bn``/``bm`` knobs are dropped too — the device of the tensors selects the
kernel (CUDA) or the plain version (CPU), and the kernel's tiles are fixed.

Every entry point takes the reference's ``compute_dtype`` ('float32' |
'bfloat16', or the 'highest' / 'mixed' precision aliases).  Under bf16 the
prescaled X is rounded to bf16, as the reference stores it at
``compute_dtype``, and staged once as the bf16 kernels read it (bf16, rows
padded to 16 features: the distance's inner product and the norms on the
tensor cores), and the product launches the bf16 kernels.  The bf16 product carries no gradient: the
MLL's backward differentiates the f32 operator, as the reference's VJP
does.

Under ``obs.enable_annotations()`` the single-device product, the fused
step and the panel-fused step each run inside a profiler range
(``cuda:kernel_matmul``, ``cuda:fused_cg_step``,
``cuda:panel_fused_cg_step``), to line the kernels up with the host spans
in a ``torch.profiler`` or Nsight capture.
"""

from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.precision import is_reduced
from repro_torch.distributed.sharding import all_gather_rows, ordered_psum, row_band

from .kernel_matmul import (
    ROW_BLOCK,
    BatchedKernelMatmulFn,
    KernelMatmulFn,
    SymKernelMatmulFn,
    _device_scalar,
    _fold_batch,
    fused_cg_step_cuda,
    kernel_matmul_cuda,
    kernel_matmul_grad_rows_cuda,
    stage_bf16,
)

#: The reference's default working-set budget for one streamed row-panel
#: (bytes): its XLA backend materializes the (panel_rows × n) slab, so this
#: caps panel_rows ≈ budget / (n·4).  A TPU VMEM / HBM artifact, kept so
#: that the chooser gives the reference's integers.
PANEL_BUDGET_BYTES = 128 * 1024 * 1024

#: Panel heights are floored to this multiple (the reference's Pallas row
#: tile and lane grid); also the smallest panel the chooser returns.
PANEL_ALIGN = 128

#: The reference never streams a taller panel than this.
MAX_PANEL_ROWS = 8192

#: f32 (batch, panel_rows, t) row-state slabs a fused panel launch keeps
#: live (U/R/D/V in and out) — the reference's ``_FUSED_STATE_SLABS``.
_FUSED_STATE_SLABS = 8

#: Row blocks of B1 / B3 an SM holds at once at the CG width (t ≤ 16
#: columns a block, d ≤ 8: three blocks of 64 rows, PERF.md §6).  At other
#: widths an SM holds one or two; a panel of whole three-block waves is
#: then still whole waves at one block an SM, and within half a wave of
#: whole at two.
ROW_BLOCKS_PER_SM = 3


def cuda_panel_rows(n: int, sms: int) -> int:
    """The cuda backend's default panel height on a card of ``sms``
    streaming multiprocessors: the tallest whole number of waves of row
    blocks (``sms · ROW_BLOCKS_PER_SM · ROW_BLOCK`` rows a wave) shorter
    than n, so that every panel but the last fills the card and the path
    still streams more than one panel; n itself when n is one wave or
    less.  Its kernels hold 64-row tiles in shared memory and never form
    the (panel_rows × n) slab, so no byte budget binds them: a launch's
    cost beyond its rows is the idle SMs of its last wave, and the
    panel-height sweep (``chip_smoke.py`` phase ``panel_sweep``, PERF.md
    §6) ran faster the more waves a launch held."""
    wave = int(sms) * ROW_BLOCKS_PER_SM * ROW_BLOCK
    return (n - 1) // wave * wave if n > wave else n


def prescale_inputs(X: torch.Tensor, lengthscale, compute_dtype="float32") -> torch.Tensor:
    """X/ℓ in f32, contiguous — everything about X the kernel needs that
    does not change across CG iterations; call once per solve.  Under a
    bf16 ``compute_dtype`` the quotient (taken in f32) is rounded to bf16
    and kept as f32 values, and on the card the bf16 kernels' padded copy
    of it is staged here, once (:func:`.kernel_matmul.stage_bf16`)."""
    Xs = (X / lengthscale).to(torch.float32)
    return round_prescaled(Xs) if is_reduced(compute_dtype) else Xs.contiguous()


def round_prescaled(Xs: torch.Tensor) -> torch.Tensor:
    """Prescaled X as a bf16 ``compute_dtype`` stores it: rounded to bf16,
    kept as f32 values, contiguous, and on the card staged once as the bf16
    kernels read it (:func:`.kernel_matmul.stage_bf16`)."""
    Xs = Xs.to(torch.bfloat16).to(torch.float32).contiguous()
    if Xs.device.type == "cuda":
        stage_bf16(Xs)
    return Xs


def fused_kernel_matmul_prescaled(
    Xs_rows: torch.Tensor,
    Xs_cols: torch.Tensor,
    M: torch.Tensor,
    outputscale,
    sigma2,
    row_offset: int = 0,
    *,
    kernel_type: str = "rbf",
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """(K(X1,X2)+σ²I) @ M for pre-scaled inputs. Returns f32 (…, rows, t).

    M may be (cols,), (cols, t) or (b, cols, t); a vector comes back as a
    vector.  Non-contiguous M (a column slice of a solve block, say) is made
    contiguous here, never read with the wrong strides.  The f32 product
    is differentiable — :class:`SymKernelMatmulFn` (one gradient-kernel
    launch per backward) when ``Xs_rows is Xs_cols`` and ``row_offset`` is
    0, else :class:`KernelMatmulFn`, and a batched M through
    :class:`BatchedKernelMatmulFn` (one gradient-kernel launch over the
    batch folded into columns); the bf16 one is not."""
    squeeze = M.dim() == 1
    if squeeze:
        M = M[:, None]
    M = M.to(torch.float32).contiguous()
    symmetric = Xs_rows is Xs_cols and int(row_offset) == 0
    Xs_rows, Xs_cols = Xs_rows.contiguous(), Xs_cols.contiguous()
    with obs.annotation("cuda:kernel_matmul"):
        out = _kernel_matmul_fn(Xs_rows, Xs_cols, M, outputscale, sigma2, row_offset,
                                kernel_type, compute_dtype, symmetric)
    return out[..., 0] if squeeze else out


def _kernel_matmul_fn(Xs_rows, Xs_cols, M, outputscale, sigma2, row_offset, kernel_type,
                      compute_dtype, symmetric):
    """The product through the autograd Function its shape calls for (the
    bf16 one without a gradient)."""
    if is_reduced(compute_dtype):
        with torch.no_grad():
            return kernel_matmul_cuda(
                Xs_rows, Xs_cols, M, outputscale, sigma2, row_offset,
                kernel_type=kernel_type, compute_dtype=compute_dtype,
            )
    if M.dim() == 3:
        return BatchedKernelMatmulFn.apply(
            Xs_rows, Xs_rows if symmetric else Xs_cols, M,
            _device_scalar(outputscale, M.device), _device_scalar(sigma2, M.device),
            row_offset, kernel_type, symmetric,
        )
    if symmetric:
        return SymKernelMatmulFn.apply(
            Xs_rows, M, _device_scalar(outputscale, M.device), _device_scalar(sigma2, M.device),
            kernel_type,
        )
    return KernelMatmulFn.apply(
        Xs_rows, Xs_cols, M, _device_scalar(outputscale, M.device),
        _device_scalar(sigma2, M.device), row_offset, kernel_type,
    )


def fused_kernel_matmul(X, M, lengthscale, outputscale, sigma2, *, kernel_type="rbf",
                        compute_dtype="float32"):
    """(K(X,X)+σ²I) @ M via the fused kernel (any n — no padding of M)."""
    Xs = prescale_inputs(X, lengthscale, compute_dtype)
    return fused_kernel_matmul_prescaled(
        Xs, Xs, M, outputscale, sigma2, kernel_type=kernel_type, compute_dtype=compute_dtype
    )


def stationary_kernel_type(kernel) -> str:
    """The kernel-type code of a port kernel object (rbf / matern12/32/52)."""
    from repro_torch.gp.kernels import MaternKernel, RBFKernel

    if isinstance(kernel, RBFKernel):
        return "rbf"
    if isinstance(kernel, MaternKernel):
        return {0.5: "matern12", 1.5: "matern32", 2.5: "matern52"}[kernel.nu]
    raise TypeError(f"the cuda path supports stationary kernels, got {kernel}")


def _flatten_state(x: torch.Tensor, n: int, t: int) -> torch.Tensor:
    """(…, n, t) → contiguous f32 (b, n, t), b = 1 without leading dims."""
    return x.to(torch.float32).reshape(-1, n, t).contiguous()


def fused_cg_step(
    Xs_rows, Xs_cols, U, R, D, V, R_cols, D_cols, V_cols, alpha, beta, gamma,
    outputscale, sigma2, row_offset: int = 0, *, kernel_type: str = "rbf",
    compute_dtype: str = "float32",
):
    """One fused CG iteration of K̂ = K(X, X) + σ²I over this call's rows
    (``row_offset`` places them in the full matrix): the reference's
    ``_fused_cg_step_padded`` without its lane padding.

    Flattens the leading batch dims of the (…, n, t) state and the (…, t)
    scalars to (b, n, t) / (b, t), runs B3 (the plain version on CPU
    tensors), and restores the shapes: returns (U′, R′, D′, V′,
    (dᵀV, rᵀr, rᵀV, vᵀV)) with each reduction (…, t).  A column with
    α = β = γ = 0 keeps its U and R, and one whose state is all zero adds
    exactly 0 to every reduction, so padded probe columns need no
    stripping."""
    rows, t = U.shape[-2:]
    cols = R_cols.shape[-2]
    lead = U.shape[:-2]
    state = [_flatten_state(x, rows, t) for x in (U, R, D, V)]
    col_state = [_flatten_state(x, cols, t) for x in (R_cols, D_cols, V_cols)]
    b = state[0].shape[0]
    scalars = [
        torch.as_tensor(s, dtype=torch.float32, device=U.device).expand(*lead, t)
        .reshape(b, t).contiguous()
        for s in (alpha, beta, gamma)
    ]
    with obs.annotation("cuda:fused_cg_step"):
        Un, Rn, Dn, Vn, red = fused_cg_step_cuda(
            Xs_rows.contiguous(), Xs_cols.contiguous(), *state, *col_state, *scalars,
            outputscale, sigma2, row_offset, kernel_type=kernel_type,
            compute_dtype=compute_dtype,
        )
    Un, Rn, Dn, Vn = (x.reshape(*lead, rows, t) for x in (Un, Rn, Dn, Vn))
    red = red.reshape(*lead, 4, t)
    return Un, Rn, Dn, Vn, tuple(red[..., k, :] for k in range(4))


def fused_cg_step_prescaled(
    Xs, U, R, D, V, alpha, beta, gamma, outputscale, sigma2, *, kernel_type="rbf",
    compute_dtype="float32",
):
    """One fused CG iteration of K̂ = K(X, X) + σ²I for pre-scaled inputs on
    one device — the :data:`repro_torch.core.mbcg.CGStepFn` of the prepared
    kernel operator: the state is its own column side."""
    return fused_cg_step(
        Xs, Xs, U, R, D, V, R, D, V, alpha, beta, gamma, outputscale, sigma2,
        kernel_type=kernel_type, compute_dtype=compute_dtype,
    )


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def choose_panel_rows(n, *, budget_bytes=None, itemsize=4, rhs_cols=0, batch=1, fused=False):
    """Largest aligned panel height whose streamed working set fits the
    byte budget — the reference's auto-chooser (``ops.py:103``), the same
    formula and the same integers.

    The plain matmul's working set is the (panel_rows × n) slab; with
    ``fused=True`` also :data:`_FUSED_STATE_SLABS` f32 (batch, panel_rows,
    t) row-state slabs per panel and the resident f32 (R, V, D) column
    state plus the (4, t) reductions.  Returns a multiple of
    :data:`PANEL_ALIGN` in [PANEL_ALIGN, min(n, MAX_PANEL_ROWS)] (rounded
    up to the alignment at small n)."""
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    budget = PANEL_BUDGET_BYTES if budget_bytes is None else int(budget_bytes)
    if budget <= 0:
        raise ValueError(f"budget_bytes must be positive, got {budget}")
    per_row = n * itemsize
    overhead = 0
    if fused:
        t = max(int(rhs_cols), 1)
        b = max(int(batch), 1)
        per_row += _FUSED_STATE_SLABS * b * t * 4
        overhead = 3 * n * b * t * 4 + 4 * t * 4
    rows = max(budget - overhead, 0) // max(per_row, 1)
    rows = (rows // PANEL_ALIGN) * PANEL_ALIGN
    rows = max(PANEL_ALIGN, min(rows, MAX_PANEL_ROWS))
    return min(rows, _ceil_to(n, PANEL_ALIGN))


def panel_matmul_prescaled(Xs, M, outputscale, panel_rows, *, kernel_type="rbf",
                           compute_dtype="float32"):
    """K(X, X) @ M for pre-scaled X, streamed one (panel_rows × n) row-panel
    at a time: one B1 (2-D M) or B2 (3-D M) launch per panel on the panel's
    rows with its global ``row_offset``, σ² = 0.  A last panel that does
    not divide is launched at its own height.  Not differentiable by itself
    (:class:`repro_torch.core.linear_operator._PartitionedMatmulFn` is).
    Returns f32 (…, n, t)."""
    Xs = Xs.contiguous()
    return band_matmul_prescaled(Xs, M, outputscale, 0, Xs.shape[0], panel_rows,
                                 kernel_type=kernel_type, compute_dtype=compute_dtype)


def band_matmul_prescaled(Xs, M, outputscale, start, stop, panel_rows=None, *,
                          kernel_type="rbf", compute_dtype="float32"):
    """Rows ``[start, stop)`` of K(X, X) @ M for pre-scaled X: one B1/B2
    launch per (panel_rows × n) panel of the band, each at its global
    ``row_offset`` (``panel_rows=None``: the band in one launch).  Returns
    f32 (…, stop − start, t)."""
    M = M.to(torch.float32).contiguous()
    rows = stop - start
    p = rows if panel_rows is None else max(1, min(int(panel_rows), rows))
    outs = [
        kernel_matmul_cuda(Xs[s : min(s + p, stop)], Xs, M, outputscale, 0.0, s,
                           kernel_type=kernel_type, compute_dtype=compute_dtype)
        for s in range(start, stop, p)
    ]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-2)


def panel_vjp_prescaled(Xs, M, C, outputscale, panel_rows, *, kernel_type="rbf"):
    """The vector-Jacobian product of K(X, X)·M (σ² = 0, X pre-scaled) for
    a cotangent C, for X and the outputscale, streamed by row-panels:
    (∂/∂Xs (n, d), ∂/∂outputscale).

    M and C are (…, n, t), the batch folded into columns.  With one X on
    both sides the weight of row i and column j is ⟨Cᵢ, Mⱼ⟩ + ⟨Mᵢ, Cⱼ⟩, so
    ONE gradient-kernel launch per panel — the panel's rows against all
    columns, A = [C | M] of its rows, B = [M | C] — gives those rows' whole
    gradient; the launches' outputscale sums (twice the derivative) are
    folded in panel order."""
    Xs = Xs.contiguous()
    gX, gsum = band_vjp_prescaled(Xs, M, C, outputscale, 0, Xs.shape[0], panel_rows,
                                  kernel_type=kernel_type)
    return gX, 0.5 * gsum


def band_vjp_prescaled(Xs, M, C, outputscale, start, stop, panel_rows=None, *,
                       kernel_type="rbf"):
    """Rows ``[start, stop)`` of :func:`panel_vjp_prescaled`: the band's
    rows of ∂/∂Xs (stop − start, d) and the band's outputscale sum Σ
    (TWICE its share of the derivative), one gradient-kernel launch per
    panel of the band (``panel_rows=None``: one for the band), the sums
    folded in panel order from zeros."""
    M2, C2 = _fold_batch(M.to(torch.float32)), _fold_batch(C.to(torch.float32))
    B = torch.cat([M2, C2], dim=1).contiguous()
    rows = stop - start
    p = rows if panel_rows is None else max(1, min(int(panel_rows), rows))
    gX = torch.empty((rows, Xs.shape[1]), dtype=torch.float32, device=Xs.device)
    gsum = torch.zeros((), dtype=torch.float32, device=Xs.device)
    for s in range(start, stop, p):
        e = min(s + p, stop)
        A = torch.cat([C2[s:e], M2[s:e]], dim=1).contiguous()
        G, g = kernel_matmul_grad_rows_cuda(Xs[s:e], Xs, A, B, outputscale,
                                            kernel_type=kernel_type)
        gX[s - start : e - start] = G
        gsum = gsum + g
    return gX, gsum


def _panel_fused_cg_step_bands(
    Xs_rows, Xs_cols, U, R, D, V, R_cols, D_cols, V_cols, alpha, beta, gamma,
    outputscale, sigma2, row0, *, panel_rows, kernel_type="rbf", compute_dtype="float32",
):
    """One fused CG iteration over a contiguous row band, one B3 launch per
    (panel_rows × cols) panel with ``row_offset = row0 + start`` — the
    reference's ``_panel_fused_cg_step_bands`` (``ops.py:503``).

    Each launch applies the pending update to its own rows only and reads
    the column side's (R, D, V) — the full PRE-update state, the same
    tensors for every panel — to recompute this iteration's direction, so
    panel order changes no V row.  B3 writes new tensors and never its
    inputs, so a panel's outputs cannot reach the next panel's column
    state.  The per-panel [dᵀV; rᵀr; rᵀV; vᵀV] partials are folded in
    panel order from zeros (no atomics).  A last panel that does not
    divide is launched at its own height, never padded (padded rows would
    add σ² terms to vᵀV).  Returns the band's (U′, R′, D′, V′) and the four
    (…, t) partial sums of its rows."""
    rows = Xs_rows.shape[0]
    p = max(1, min(int(panel_rows), rows))
    t = U.shape[-1]
    red = [torch.zeros(U.shape[:-2] + (t,), dtype=torch.float32, device=U.device)
           for _ in range(4)]
    outs = ([], [], [], [])
    for s in range(0, rows, p):
        e = min(s + p, rows)
        *state, part = fused_cg_step(
            Xs_rows[s:e], Xs_cols, U[..., s:e, :], R[..., s:e, :], D[..., s:e, :],
            V[..., s:e, :], R_cols, D_cols, V_cols, alpha, beta, gamma, outputscale, sigma2,
            row0 + s, kernel_type=kernel_type, compute_dtype=compute_dtype,
        )
        for out, x in zip(outs, state):
            out.append(x)
        red = [r + q for r, q in zip(red, part)]
    U2, R2, D2, V2 = (torch.cat(o, dim=-2) for o in outs)
    return U2, R2, D2, V2, tuple(red)


def panel_fused_cg_step_prescaled(
    Xs, U, R, D, V, alpha, beta, gamma, outputscale, sigma2, *, panel_rows,
    kernel_type="rbf", compute_dtype="float32",
):
    """One fused CG iteration of K̂ = K(X, X) + σ²I streamed by row-panels on
    one device — the partitioned :data:`repro_torch.core.mbcg.CGStepFn`:
    one B3 launch per panel, the column state the full pre-update (R, D, V)
    (:func:`_panel_fused_cg_step_bands`)."""
    R, D, V = (x.to(torch.float32).contiguous() for x in (R, D, V))
    with obs.annotation("cuda:panel_fused_cg_step"):
        return _panel_fused_cg_step_bands(
            Xs.contiguous(), Xs.contiguous(), U, R, D, V, R, D, V, alpha, beta, gamma,
            outputscale, sigma2, 0, panel_rows=panel_rows, kernel_type=kernel_type,
            compute_dtype=compute_dtype,
        )


# ---------------------------------------------------------------------------
# Row-sharded over a mesh (global view: every rank holds the full operands)
# ---------------------------------------------------------------------------


def _sharded_product(Xs, M, outputscale, mesh, axes, panel_rows, kernel_type, compute_dtype):
    """This rank's band of K(X, X)·M (one B1/B2 launch, or one per panel of
    the band, at the band's ``row_offset``), all-gathered: the full f32
    product, the same bits on every rank."""
    start, stop = row_band(Xs.shape[0], mesh, axes)
    band = band_matmul_prescaled(Xs, M, outputscale, start, stop, panel_rows,
                                 kernel_type=kernel_type, compute_dtype=compute_dtype)
    return all_gather_rows(band, mesh, axes)


class ShardedMatmulFn(torch.autograd.Function):
    """K(X, X)·M for pre-scaled X with the rows sharded over a mesh,
    differentiable in Xs, M and the outputscale — the sharded twin of
    :class:`repro_torch.core.linear_operator._PartitionedMatmulFn`.

    Forward: the band's launch(es) and one all-gather of the (…, n, t)
    output.  Backward: the cotangent C is the full one, the same on every
    rank.  Each rank runs the gradient kernel's row variant over its band
    (A = [C | M] of its rows, B = [M | C]: the band's rows' whole gradient
    and twice their share of the outputscale's), the Xs rows are
    all-gathered and the outputscale partials folded with
    :func:`~repro_torch.distributed.sharding.ordered_psum`; ∂M = K·C is
    one more sharded forward (K is symmetric)."""

    @staticmethod
    def forward(ctx, Xs, M, outputscale, mesh, axes, panel_rows, kernel_type):
        ctx.save_for_backward(Xs, M, outputscale)
        ctx.mesh, ctx.axes, ctx.panel_rows, ctx.kernel_type = mesh, axes, panel_rows, kernel_type
        return _sharded_product(Xs, M, outputscale, mesh, axes, panel_rows, kernel_type,
                                "float32")

    @staticmethod
    def backward(ctx, C):
        Xs, M, s = ctx.saved_tensors
        need = ctx.needs_input_grad
        mesh, axes, p, kt = ctx.mesh, ctx.axes, ctx.panel_rows, ctx.kernel_type
        C = C.contiguous()
        gXs = gM = gs = None
        if need[0] or need[2]:
            start, stop = row_band(Xs.shape[0], mesh, axes)
            G, g = band_vjp_prescaled(Xs, M, C, s, start, stop, p, kernel_type=kt)
            gXs = all_gather_rows(G, mesh, axes, dim=0)
            gs = (0.5 * ordered_psum(g.reshape(1), mesh, axes)).reshape(s.shape)
        if need[1]:
            gM = _sharded_product(Xs, C, s, mesh, axes, p, kt, "float32")
        return gXs, gM, gs, None, None, None, None


def sharded_kernel_matmul_prescaled(Xs, M, outputscale, mesh, axes=("data",), *,
                                    panel_rows=None, kernel_type="rbf",
                                    compute_dtype="float32"):
    """Row-partitioned K(X, X) @ M over ``mesh`` for pre-scaled X — the
    reference's ``sharded_kernel_matmul_prescaled`` in the global view.

    Every rank passes the full Xs and M (2-D, B1; or (b, n, t), B2) and gets
    the full f32 product back: it launches the kernel on its own row band
    ``[i·n/S, (i+1)·n/S)`` with the band's global ``row_offset`` (one launch,
    or one per ``panel_rows`` panel of the band), and the bands are
    all-gathered — the one collective, n·t values, the bytes the
    reference's all-gather of M moves.  An n the shards do not divide
    raises ``ValueError``.  Under bf16 the bf16 kernel rounds M to bf16 (the
    reference's cast before its gather; here M is not gathered) and the
    output bands travel in f32, as the reference's output does.  The f32
    product is differentiable (:class:`ShardedMatmulFn`), the bf16 one not."""
    squeeze = M.dim() == 1
    if squeeze:
        M = M[:, None]
    M = M.to(torch.float32).contiguous()
    Xs, axes = Xs.contiguous(), tuple(axes)
    with obs.annotation("cuda:sharded_kernel_matmul"):
        if is_reduced(compute_dtype):
            with torch.no_grad():
                out = _sharded_product(Xs, M, outputscale, mesh, axes, panel_rows,
                                       kernel_type, compute_dtype)
        else:
            s = torch.as_tensor(outputscale, dtype=torch.float32, device=M.device).reshape(())
            out = ShardedMatmulFn.apply(Xs, M, s, mesh, axes, panel_rows, kernel_type)
    return out[..., 0] if squeeze else out


def sharded_kernel_matmul(kernel, X, M, mesh, axes=("data",), *, compute_dtype="float32"):
    """Row-partitioned K(X, X) @ M over a mesh (prescales per call — the CG
    loop goes through ``KernelOperator.prepare()``, which prescales once)."""
    return sharded_kernel_matmul_prescaled(
        prescale_inputs(X, kernel.lengthscale, compute_dtype), M, kernel.outputscale, mesh, axes,
        kernel_type=stationary_kernel_type(kernel), compute_dtype=compute_dtype,
    )


def sharded_fused_cg_step_prescaled(
    Xs, U, R, D, V, alpha, beta, gamma, outputscale, sigma2, mesh, axes=("data",), *,
    panel_rows=None, kernel_type="rbf", compute_dtype="float32",
):
    """One fused CG iteration of K̂ = K(X, X) + σ²I with the rows sharded
    over ``mesh`` — the sharded :data:`repro_torch.core.mbcg.CGStepFn`, the
    reference's ``sharded_fused_cg_step_prescaled`` in the global view.

    Every rank holds the full pre-update (U, R, D, V), so the column side B3
    recomputes this iteration's direction from is the full (R, D, V) with
    no gather.  The rank applies the pending (α, β, γ) update to its own
    band inside B3 at the band's ``row_offset`` and forms the band's V′ and
    partial reductions — one launch for the band (``panel_rows=None``), or
    one per panel through :func:`_panel_fused_cg_step_bands`.  Then two
    collectives: one all-gather of the four updated bands (4·n·t values),
    and :func:`~repro_torch.distributed.sharding.ordered_psum` of the
    (…, 4, t) partials (the reference: three gathers of n·t and one psum).
    With one panel per band the fold is the single-device panel loop's, so
    1-rank and S-rank panel-fused solves agree bit for bit."""
    n = Xs.shape[0]
    axes = tuple(axes)
    start, stop = row_band(n, mesh, axes)
    R, D, V = (x.to(torch.float32).contiguous() for x in (R, D, V))
    Xs = Xs.contiguous()
    bands = [x[..., start:stop, :] for x in (U, R, D, V)]
    kw = dict(kernel_type=kernel_type, compute_dtype=compute_dtype)
    with obs.annotation("cuda:sharded_fused_cg_step"):
        if panel_rows is None:
            *state, red = fused_cg_step(Xs[start:stop], Xs, *bands, R, D, V, alpha, beta,
                                        gamma, outputscale, sigma2, start, **kw)
        else:
            *state, red = _panel_fused_cg_step_bands(
                Xs[start:stop], Xs, *bands, R, D, V, alpha, beta, gamma, outputscale, sigma2,
                start, panel_rows=panel_rows, **kw)
        red = ordered_psum(torch.stack(red, dim=-2), mesh, axes)
        full = all_gather_rows(torch.stack(state), mesh, axes)
    Un, Rn, Dn, Vn = full.unbind(0)
    return Un, Rn, Dn, Vn, tuple(red[..., k, :] for k in range(4))

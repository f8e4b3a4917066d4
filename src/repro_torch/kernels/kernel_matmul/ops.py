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
    ``row_offset``.

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
``compute_dtype`` (the kernels read those values widened to f32: the same
numbers, and the distance stays one f32 fmaf chain), and the product
launches the bf16 kernels.  The bf16 product carries no gradient: the
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
    and kept as f32 values."""
    Xs = (X / lengthscale).to(torch.float32)
    if is_reduced(compute_dtype):
        Xs = Xs.to(torch.bfloat16).to(torch.float32)
    return Xs.contiguous()


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
    M = M.to(torch.float32).contiguous()
    Xs = Xs.contiguous()
    n = Xs.shape[0]
    p = max(1, min(int(panel_rows), n))
    outs = [
        kernel_matmul_cuda(Xs[s : s + p], Xs, M, outputscale, 0.0, s, kernel_type=kernel_type,
                           compute_dtype=compute_dtype)
        for s in range(0, n, p)
    ]
    return torch.cat(outs, dim=-2)


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
    M2, C2 = _fold_batch(M.to(torch.float32)), _fold_batch(C.to(torch.float32))
    B = torch.cat([M2, C2], dim=1).contiguous()
    Xs = Xs.contiguous()
    n = Xs.shape[0]
    p = max(1, min(int(panel_rows), n))
    gX = torch.empty_like(Xs)
    gsum = torch.zeros((), dtype=torch.float32, device=Xs.device)
    for s in range(0, n, p):
        A = torch.cat([C2[s : s + p], M2[s : s + p]], dim=1).contiguous()
        G, g = kernel_matmul_grad_rows_cuda(Xs[s : s + p], Xs, A, B, outputscale,
                                            kernel_type=kernel_type)
        gX[s : s + p] = G
        gsum = gsum + g
    return gX, 0.5 * gsum


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

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

A 2-D product goes through :class:`.kernel_matmul.KernelMatmulFn` (or
:class:`.kernel_matmul.SymKernelMatmulFn` when one X is on both sides), so
it is differentiable in X (hence the lengthscale), the outputscale and σ²,
with the gradient kernel as its backward.

The reference's 128-lane feature padding and M lane padding are TPU layout
artifacts and are dropped: zero feature columns do not change distances,
and the CUDA kernels mask every ragged edge themselves.  Its ``interpret`` and
``bn``/``bm`` knobs are dropped too — the device of the tensors selects the
kernel (CUDA) or the plain version (CPU), and the kernel's tiles are fixed
— and so is ``compute_dtype``: only f32 ("highest") is ported; the bf16
operands come with ROADMAP Queue A step 10.
"""

from __future__ import annotations

import torch

from .kernel_matmul import (
    KernelMatmulFn,
    SymKernelMatmulFn,
    _device_scalar,
    fused_cg_step_cuda,
    kernel_matmul_cuda,
)


def prescale_inputs(X: torch.Tensor, lengthscale) -> torch.Tensor:
    """X/ℓ in f32, contiguous — everything about X the kernel needs that
    does not change across CG iterations; call once per solve."""
    return (X / lengthscale).to(torch.float32).contiguous()


def fused_kernel_matmul_prescaled(
    Xs_rows: torch.Tensor,
    Xs_cols: torch.Tensor,
    M: torch.Tensor,
    outputscale,
    sigma2,
    row_offset: int = 0,
    *,
    kernel_type: str = "rbf",
) -> torch.Tensor:
    """(K(X1,X2)+σ²I) @ M for pre-scaled inputs. Returns f32 (…, rows, t).

    M may be (cols,), (cols, t) or (b, cols, t); a vector comes back as a
    vector.  Non-contiguous M (a column slice of a solve block, say) is made
    contiguous here, never read with the wrong strides.  The 2-D product
    is differentiable — :class:`SymKernelMatmulFn` (one gradient-kernel
    launch per backward) when ``Xs_rows is Xs_cols`` and ``row_offset`` is
    0, else :class:`KernelMatmulFn`; the batched one is not."""
    squeeze = M.dim() == 1
    if squeeze:
        M = M[:, None]
    M = M.to(torch.float32).contiguous()
    symmetric = Xs_rows is Xs_cols and int(row_offset) == 0
    Xs_rows, Xs_cols = Xs_rows.contiguous(), Xs_cols.contiguous()
    if M.dim() == 3:
        out = kernel_matmul_cuda(
            Xs_rows, Xs_cols, M, outputscale, sigma2, row_offset, kernel_type=kernel_type
        )
    elif symmetric:
        out = SymKernelMatmulFn.apply(
            Xs_rows, M, _device_scalar(outputscale, M.device), _device_scalar(sigma2, M.device),
            kernel_type,
        )
    else:
        out = KernelMatmulFn.apply(
            Xs_rows, Xs_cols, M, _device_scalar(outputscale, M.device),
            _device_scalar(sigma2, M.device), row_offset, kernel_type,
        )
    return out[..., 0] if squeeze else out


def fused_kernel_matmul(X, M, lengthscale, outputscale, sigma2, *, kernel_type="rbf"):
    """(K(X,X)+σ²I) @ M via the fused kernel (any n — no padding of M)."""
    Xs = prescale_inputs(X, lengthscale)
    return fused_kernel_matmul_prescaled(
        Xs, Xs, M, outputscale, sigma2, kernel_type=kernel_type
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
    Un, Rn, Dn, Vn, red = fused_cg_step_cuda(
        Xs_rows.contiguous(), Xs_cols.contiguous(), *state, *col_state, *scalars,
        outputscale, sigma2, row_offset, kernel_type=kernel_type,
    )
    Un, Rn, Dn, Vn = (x.reshape(*lead, rows, t) for x in (Un, Rn, Dn, Vn))
    red = red.reshape(*lead, 4, t)
    return Un, Rn, Dn, Vn, tuple(red[..., k, :] for k in range(4))


def fused_cg_step_prescaled(
    Xs, U, R, D, V, alpha, beta, gamma, outputscale, sigma2, *, kernel_type="rbf"
):
    """One fused CG iteration of K̂ = K(X, X) + σ²I for pre-scaled inputs on
    one device — the :data:`repro_torch.core.mbcg.CGStepFn` of the prepared
    kernel operator: the state is its own column side."""
    return fused_cg_step(
        Xs, Xs, U, R, D, V, R, D, V, alpha, beta, gamma, outputscale, sigma2,
        kernel_type=kernel_type,
    )

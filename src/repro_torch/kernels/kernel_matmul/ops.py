"""Public wrappers for the fused kernel matmul (counterpart of
``repro.kernels.kernel_matmul.ops``).

  * :func:`prescale_inputs` — the once-per-solve work, X/ℓ (ARD broadcasts a
    (d,) ℓ).  ``KernelOperator.prepare()`` hoists it out of the CG loop.
  * :func:`fused_kernel_matmul_prescaled` / :func:`fused_kernel_matmul` —
    the single-device entry points.
  * :func:`kernel_matmul` — the LinearOperator-facing dispatch from a kernel
    object.

The reference's 128-lane feature padding and M lane padding are TPU layout
artifacts and are dropped: zero feature columns do not change distances,
and the CUDA kernel masks every ragged edge itself.  Its ``interpret`` and
``bn``/``bm`` knobs are dropped too — the device of the tensors selects the
kernel (CUDA) or the plain version (CPU), and the kernel's tiles are fixed
— and so is ``compute_dtype``: only f32 ("highest") is ported; the bf16
operands come with ROADMAP Queue A step 10.
"""

from __future__ import annotations

import torch

from .kernel_matmul import kernel_matmul_cuda


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
    contiguous here, never read with the wrong strides."""
    squeeze = M.dim() == 1
    if squeeze:
        M = M[:, None]
    M = M.to(torch.float32).contiguous()
    out = kernel_matmul_cuda(
        Xs_rows.contiguous(),
        Xs_cols.contiguous(),
        M,
        outputscale,
        sigma2,
        row_offset,
        kernel_type=kernel_type,
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


def kernel_matmul(kernel, X, M):
    """LinearOperator-facing dispatch: a port kernel object onto the fused
    call (no σ² — the AddedDiagOperator adds it outside)."""
    return fused_kernel_matmul(
        X, M, kernel.lengthscale, kernel.outputscale, 0.0,
        kernel_type=stationary_kernel_type(kernel),
    )

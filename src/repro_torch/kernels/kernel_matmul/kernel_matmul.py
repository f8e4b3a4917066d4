"""Fused kernel-matrix matmul: (K(X1, X2) + σ²I_global) @ M without forming K.

Counterpart of ``repro.kernels.kernel_matmul.kernel_matmul.kernel_matmul_pallas``.
On CUDA tensors :func:`kernel_matmul_cuda` launches the hand-written sm_90a
kernel in ``csrc/kernel_matmul.cu`` (B1 for a 2-D M, the same kernel's
batch grid axis, B2, for a 3-D M), bound with ctypes; on CPU tensors it runs
the plain PyTorch version :func:`.ref.kernel_matmul_plain`.  There is no
fallback between the two: a CUDA tensor launches the kernel or raises.

``launches`` / ``batched_launches`` count the kernel launches (2-D and
3-D M), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import torch

from .build import load_library
from .ref import KERNEL_TYPES, kernel_matmul_plain

KERNEL_TYPE_CODES = {name: i for i, name in enumerate(KERNEL_TYPES)}

#: kernel launches with a 2-D M (B1) since the last reset
launches = 0
#: kernel launches with a 3-D M (B2) since the last reset
batched_launches = 0


def reset_launch_counts() -> None:
    global launches, batched_launches
    launches = 0
    batched_launches = 0


def _device_scalar(v, device) -> torch.Tensor:
    # torch.full, not torch.tensor: a Python float becomes a device fill, not
    # a host-to-device copy that would synchronise the stream
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _check_cuda_args(X1, X2, M, kernel_type, row_offset):
    devices = {x.device for x in (X1, X2, M)}
    if len(devices) != 1 or not X1.is_cuda:
        raise ValueError(
            f"kernel_matmul: X1, X2 and M must all lie on one CUDA device or "
            f"all on the CPU, got {sorted(map(str, devices))}"
        )
    for name, x in (("X1", X1), ("X2", X2), ("M", M)):
        if x.dtype != torch.float32:
            raise TypeError(f"kernel_matmul: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(
                f"kernel_matmul: {name} must be contiguous (the kernel reads "
                f"row-major storage); pass {name}.contiguous()"
            )
    if X1.dim() != 2 or X2.dim() != 2 or X1.shape[1] != X2.shape[1]:
        raise ValueError(
            f"kernel_matmul: X1 (rows, d) and X2 (cols, d) expected, got "
            f"{tuple(X1.shape)} and {tuple(X2.shape)}"
        )
    if M.dim() not in (2, 3) or M.shape[-2] != X2.shape[0]:
        raise ValueError(
            f"kernel_matmul: M must be (cols, t) or (b, cols, t) with cols = "
            f"{X2.shape[0]}, got {tuple(M.shape)}"
        )
    if kernel_type not in KERNEL_TYPE_CODES:
        raise ValueError(f"kernel_matmul: unknown kernel_type {kernel_type!r}")
    if not 0 <= int(row_offset) < 2**31 - X1.shape[0]:
        raise ValueError(f"kernel_matmul: row_offset {row_offset} out of int32 range")
    if max(X1.shape[0], X2.shape[0], M.shape[-1]) >= 2**31:
        raise ValueError("kernel_matmul: dimensions must fit in int32")
    if M.dim() == 3 and M.shape[0] > 65535:
        raise ValueError("kernel_matmul: batch dim must be at most 65535")


def kernel_matmul_cuda(
    X1: torch.Tensor,
    X2: torch.Tensor,
    M: torch.Tensor,
    outputscale,
    sigma2,
    row_offset: int = 0,
    *,
    kernel_type: str = "rbf",
) -> torch.Tensor:
    """(K(X1, X2) + σ²·[row_offset + i == j]) @ M → (rows, t) or (b, rows, t).

    X1 (rows, d) and X2 (cols, d) are pre-divided by the lengthscale; M is
    (cols, t) or (b, cols, t); all f32 and contiguous.  ``outputscale`` and
    ``sigma2`` are floats or 0-d tensors; ``row_offset`` is the global row
    index of X1[0] (a host int).  The output is f32.
    """
    if all(x.device.type == "cpu" for x in (X1, X2, M)):
        return kernel_matmul_plain(
            X1, X2, M, outputscale, sigma2, row_offset, kernel_type=kernel_type
        )
    _check_cuda_args(X1, X2, M, kernel_type, row_offset)
    global launches, batched_launches
    batched = M.dim() == 3
    rows, d = X1.shape
    cols, t = M.shape[-2:]
    batch = M.shape[0] if batched else 1
    out_shape = (batch, rows, t) if batched else (rows, t)
    out = torch.empty(out_shape, dtype=torch.float32, device=M.device)
    if rows == 0 or t == 0 or batch == 0:
        return out
    scal = torch.stack(
        [_device_scalar(outputscale, M.device), _device_scalar(sigma2, M.device)]
    )
    lib = load_library()
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        err = lib.kernel_matmul_f32(
            X1.data_ptr(), X2.data_ptr(), M.data_ptr(), scal.data_ptr(),
            out.data_ptr(), rows, cols, d, t, batch, int(row_offset),
            KERNEL_TYPE_CODES[kernel_type], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"kernel_matmul_f32 launch failed with cudaError {err} "
            f"(rows={rows}, cols={cols}, d={d}, t={t}, batch={batch})"
        )
    if batched:
        batched_launches += 1
    else:
        launches += 1
    return out

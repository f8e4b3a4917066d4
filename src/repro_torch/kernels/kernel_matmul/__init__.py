"""The fused kernel-matrix matmul: CUDA kernel, plain version, wrappers.

The launch counters live on the submodule:
``repro_torch.kernels.kernel_matmul.kernel_matmul.launches``.
"""

from .kernel_matmul import kernel_matmul_cuda, reset_launch_counts
from .ops import fused_kernel_matmul, fused_kernel_matmul_prescaled, prescale_inputs
from .ref import kernel_matmul_plain, kernel_matmul_ref

__all__ = [
    "fused_kernel_matmul",
    "fused_kernel_matmul_prescaled",
    "kernel_matmul_cuda",
    "kernel_matmul_plain",
    "kernel_matmul_ref",
    "prescale_inputs",
    "reset_launch_counts",
]

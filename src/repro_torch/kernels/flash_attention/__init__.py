"""Flash attention (B4): CUDA kernel and plain version; the GQA entry point
is ``ops.flash_attention``.

The launch counter lives on the submodule:
``repro_torch.kernels.flash_attention.flash_attention.launches``.
"""

from .flash_attention import flash_attention_cuda, reset_launch_counts
from .ref import attention_plain, gqa_attention_plain

__all__ = [
    "attention_plain",
    "flash_attention_cuda",
    "gqa_attention_plain",
    "reset_launch_counts",
]

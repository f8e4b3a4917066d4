"""The Mamba-2 SSD scan (B5): CUDA kernel, plain versions and the decode
step; the dispatch is ``ops.ssd_scan``.

The launch counter lives on the submodule:
``repro_torch.kernels.ssd_scan.ssd_scan.launches``.
"""

from .ops import ssd_decode_step
from .ref import ssd_scan_chunked_ref, ssd_scan_ref
from .ssd_scan import reset_launch_counts, ssd_scan_cuda

__all__ = [
    "reset_launch_counts",
    "ssd_decode_step",
    "ssd_scan_chunked_ref",
    "ssd_scan_cuda",
    "ssd_scan_ref",
]

"""GP models on top of the BBMM engine (counterpart of ``repro.gp``):
the exact GP, its training driver and its serving cache with streaming
updates."""

from repro_torch.core.linear_operator import (
    BatchDenseOperator,
    PanelLaunch,
    PartitionedKernelOperator,
    panel_accounting,
)

from .exact import ExactGP
from .kernels import (
    CrossKernelOperator,
    KernelOperator,
    MaternKernel,
    PreparedKernelOperator,
    RBFKernel,
    sq_dist,
)
from .model import (
    PROTOCOL_METHODS,
    STREAMING_METHODS,
    GPModel,
    KrylovCachePredictor,
    SupportsStreaming,
    missing_protocol_methods,
    supports_streaming,
)
from .training import fit_gp

"""GP models on top of the BBMM engine (counterpart of ``repro.gp``):
the exact GP, its training driver and its serving cache."""

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
from .model import PROTOCOL_METHODS, GPModel, KrylovCachePredictor, missing_protocol_methods
from .training import fit_gp

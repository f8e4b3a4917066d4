"""GP models on top of the BBMM engine (counterpart of ``repro.gp``):
the exact GP and its serving cache in this slice."""

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

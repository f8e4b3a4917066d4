"""GP models on top of the BBMM engine (counterpart of ``repro.gp``): the
exact GP, SGPR, Bayesian linear regression, deep kernel learning and the
multitask GP, their training driver, and their serving caches (Krylov and
Woodbury) with streaming updates."""

from repro_torch.core.linear_operator import (
    BatchDenseOperator,
    PanelLaunch,
    PartitionedKernelOperator,
    panel_accounting,
)

from .blr import BayesianLinearRegression
from .dkl import DKLExactGP, mlp_apply, mlp_init
from .exact import ExactGP
from .kernels import (
    CrossKernelOperator,
    DeepKernel,
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
    WoodburyCache,
    WoodburyCachePredictor,
    build_woodbury_cache,
    missing_protocol_methods,
    supports_streaming,
    woodbury_predict,
    woodbury_update,
)
from .multitask import MultitaskData, MultitaskGP, split_long_format, to_long_format
from .sgpr import SGPR
from .training import fit_gp

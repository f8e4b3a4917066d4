"""BBMM core in PyTorch: mBCG (unfused and fused), pivoted-Cholesky
preconditioning, SLQ log-dets, the differentiable MLL and the serving
engine (counterpart of ``repro.core``)."""

from .health import (
    RungRecord,
    SolveFailure,
    SolveHealthWarning,
    SolveReport,
    classify_mbcg,
    collect,
    record,
)
from .inference import (
    BBMMSettings,
    InferenceState,
    PosteriorCache,
    build_posterior_cache,
    cached_inv_quad,
    cached_mean,
    engine_state,
    inv_quad_logdet,
    marginal_log_likelihood,
    solve,
)
from .linear_operator import (
    AddedDiagOperator,
    DenseOperator,
    DiagOperator,
    LinearOperator,
    replace_tensor_leaves,
    tensor_leaves,
)
from .mbcg import MBCGResult, mbcg, plain_cg_step, tridiag_matrices
from .pivoted_cholesky import pivoted_cholesky, pivoted_cholesky_dense
from .precision import normalize_compute_dtype, precision_compute_dtype, validate_precision
from .preconditioner import (
    IdentityPreconditioner,
    PivotedCholeskyPreconditioner,
    build_preconditioner,
)
from .slq import logdet_from_mbcg, slq_quadrature

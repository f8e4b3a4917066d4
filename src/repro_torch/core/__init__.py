"""BBMM core in PyTorch: mBCG (unfused and fused), pivoted-Cholesky
preconditioning, SLQ log-dets, the differentiable MLL, the serving engine
with its streaming cache updates, the variational KL, the solve-health
ladder, the fault injection harness, the operator algebra with SKI's
structured operators, and the row-sharded pieces of the multi-device path
(the sharded pivoted Cholesky, :class:`ShardedKernelOperator`)
(counterpart of ``repro.core``)."""

from .distributed import ShardedKernelOperator
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
    extend_posterior_cache,
    cached_mean,
    engine_state,
    inv_quad_logdet,
    marginal_log_likelihood,
    solve,
)
from .linear_operator import (
    AddedDiagOperator,
    BatchDenseOperator,
    CallableOperator,
    DenseOperator,
    DiagOperator,
    FaultInjectingOperator,
    FaultSchedule,
    HadamardKroneckerOperator,
    InterpolatedOperator,
    KroneckerAddedDiagOperator,
    KroneckerKernelOperator,
    KroneckerOperator,
    LinearOperator,
    LowRankRootOperator,
    PanelLaunch,
    PartitionedKernelOperator,
    ScaledOperator,
    SumOperator,
    ToeplitzOperator,
    interpolation_order,
    panel_accounting,
    replace_tensor_leaves,
    tensor_leaves,
)
from .mbcg import CGStepFn, MBCGResult, mbcg, plain_cg_step, tridiag_matrices
from .pivoted_cholesky import (
    pivoted_cholesky,
    pivoted_cholesky_dense,
    pivoted_cholesky_sharded,
)
from .precision import normalize_compute_dtype, precision_compute_dtype, validate_precision
from .preconditioner import (
    IdentityPreconditioner,
    PivotedCholeskyPreconditioner,
    build_preconditioner,
)
from .slq import logdet_from_mbcg, slq_quadrature
from .variational import gaussian_kl, root_logdet

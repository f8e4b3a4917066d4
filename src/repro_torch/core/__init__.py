"""BBMM core in PyTorch: mBCG, pivoted-Cholesky preconditioning, SLQ
log-dets and the serving engine (counterpart of ``repro.core``)."""

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
    PosteriorCache,
    build_posterior_cache,
    cached_inv_quad,
    cached_mean,
    solve,
)
from .linear_operator import AddedDiagOperator, DenseOperator, DiagOperator, LinearOperator
from .mbcg import MBCGResult, mbcg, tridiag_matrices
from .pivoted_cholesky import pivoted_cholesky, pivoted_cholesky_dense
from .precision import normalize_compute_dtype, validate_precision
from .preconditioner import (
    IdentityPreconditioner,
    PivotedCholeskyPreconditioner,
    build_preconditioner,
)
from .slq import logdet_from_mbcg, slq_quadrature

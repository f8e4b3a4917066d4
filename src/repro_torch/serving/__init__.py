"""GP serving: versioned posterior caches with streaming updates
(counterpart of ``repro.serving``).

``PosteriorSession`` wraps a GP model behind the serving seam: cache
versioning / fingerprinting against (params, X, y), CG-free mean / variance
queries, incremental ``observe`` updates (Krylov-basis recycling) with a
``max_staleness`` rebuild policy, double-buffered refreshes, and a circuit
breaker with degraded answers.  The request driver lives in
``repro_torch.launch.gp_serve``.
"""

from .session import (
    CacheInfo,
    CircuitBreaker,
    PosteriorSession,
    QueryDeadlineExceeded,
    RebuildFailed,
    Served,
    fingerprint,
)

__all__ = [
    "CacheInfo",
    "CircuitBreaker",
    "PosteriorSession",
    "QueryDeadlineExceeded",
    "RebuildFailed",
    "Served",
    "fingerprint",
]

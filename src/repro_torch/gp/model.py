"""The `GPModel` protocol and the exact-GP serving cache (counterpart of
``repro.gp.model``).

Every GP model exposes the same structural protocol:

    prepare_inputs(X)                     -> data
    init_params(X)                        -> params
    operator(params, data)                -> LinearOperator  (the blackbox K̂)
    loss(params, data, y, generator)      -> scalar  (-MLL; training slice)
    fit(X, y, ...)                        -> (params, history)  (training slice)
    posterior_cache(params, data, y)      -> cache   (CG-free serving state)
    predict_cached(params, data, cache, Xstar) -> (mean, var)
    predict(params, data, y, Xstar)       -> (mean, var)

Streaming-capable models also implement (:class:`SupportsStreaming`)

    update_cache(params, data, y, cache, X_new, y_new) -> cache

the seam :class:`repro_torch.serving.PosteriorSession` folds appended
observations in through.  Two shared implementations of the serving
methods:

  * :class:`KrylovCachePredictor` — on top of the engine: Rayleigh–Ritz
    variances from an orthonormal Krylov basis, recycled across appends
    (ExactGP; DKL on featurized inputs; MultitaskGP over its Kronecker
    system, with its own cross-covariance);
  * :class:`WoodburyCachePredictor` — the closed-form cache of models whose
    kernel IS a low-rank root (SGPR, BLR): the serving state lives in the
    m root coordinates (G = RᵀR, b = Rᵀy), so an append is an exact rank-k
    refresh of two m-sized statistics — O(m³), zero CG, no n.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol, runtime_checkable

import torch

from repro_torch.core import (
    BBMMSettings,
    build_posterior_cache,
    cached_inv_quad,
    extend_posterior_cache,
    precision_compute_dtype,
)
from repro_torch.core import solve as bbmm_solve

PROTOCOL_METHODS = (
    "prepare_inputs",
    "init_params",
    "operator",
    "loss",
    "fit",
    "posterior_cache",
    "predict_cached",
    "predict",
)

STREAMING_METHODS = ("update_cache",)


@runtime_checkable
class GPModel(Protocol):
    """Structural protocol — see the module docstring for the contract."""

    settings: BBMMSettings

    def prepare_inputs(self, X): ...

    def init_params(self, X): ...

    def operator(self, params, data): ...

    def loss(self, params, data, y, generator): ...

    def fit(self, X, y, **kwargs): ...

    def posterior_cache(self, params, data, y): ...

    def predict_cached(self, params, data, cache, Xstar): ...

    def predict(self, params, data, y, Xstar): ...


@runtime_checkable
class SupportsStreaming(Protocol):
    """Models whose serving cache accepts incremental data appends."""

    def update_cache(self, params, data, y, cache, X_new, y_new): ...


def missing_protocol_methods(model, methods=PROTOCOL_METHODS) -> list[str]:
    """Names from ``methods`` the model fails to expose as callables."""
    return [m for m in methods if not callable(getattr(model, m, None))]


def supports_streaming(model) -> bool:
    return not missing_protocol_methods(model, STREAMING_METHODS)


class KrylovCachePredictor:
    """Exact-GP posterior cache + prediction on top of the engine.

    Mixin contract: the model provides ``operator(params, data)``,
    ``kernel(params)``, ``noise(params)``, ``settings`` and ``device``, and
    ``_tensor(x)`` to bring inputs (numpy arrays or tensors) onto it."""

    def _generator(self, generator):
        """The default generator is seeded with 0, so rebuilding the cache
        for the same (params, data, y) is deterministic — and ``predict``
        runs its mean through the same mBCG program as ``predict_cached``."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        return generator

    def posterior_cache(self, params, data, y, *, generator=None, variance_cache=True):
        """One engine call → reusable solve cache for cheap repeated queries."""
        return build_posterior_cache(
            self.operator(params, data),
            self._tensor(y),
            self._generator(generator),
            self.settings,
            variance_cache=variance_cache,
        )

    def _cross(self, params, data, Xstar):
        """The test-vs-train block, carrying the model's precision policy:
        its ``contract`` runs the served mean at the compute dtype of
        training (bf16 operands under "mixed", a plain matmul under
        "highest")."""
        from .kernels import CrossKernelOperator

        return CrossKernelOperator(
            self.kernel(params), self._tensor(data), self._tensor(Xstar),
            compute_dtype=precision_compute_dtype(self.settings.precision),
        )

    def predict_cached(self, params, data, cache, Xstar, *, full_cov=False):
        """Serve mean + variance from a PosteriorCache — zero CG iterations.

        Mean: k*ᵀα, O(n·s), contracted under the model's precision policy.
        Variance: Rayleigh–Ritz k*ᵀK̂⁻¹k* from the
        cached Krylov basis, O(n·m) — conservative (never below the exact
        posterior variance)."""
        Xstar = self._tensor(Xstar)
        kern = self.kernel(params)
        cross = self._cross(params, data, Xstar)
        Kxs = cross.to_dense()  # (n, s) — ONE kernel evaluation per query
        mean = cross.contract(Kxs.T, cache.alpha)
        if full_cov:
            if cache.basis is None:
                raise ValueError(
                    "cache was built with variance_cache=False; rebuild with "
                    "variance_cache=True for covariance queries"
                )
            v = cache.basis.T @ Kxs
            w = torch.cholesky_solve(v, cache.gram_chol)
            return mean, kern(Xstar, Xstar) - v.T @ w
        var = kern.diag(Xstar) - cached_inv_quad(cache, Kxs)
        return mean, torch.clamp(var, min=1e-8) + self.noise(params)

    def predict(self, params, data, y, Xstar, *, full_cov=False, generator=None):
        """Posterior mean and (diagonal) variance at Xstar (Eq. 1).

        Builds the posterior cache without its variance stage (the mean is
        the same mBCG program as ``predict_cached``'s cache), then runs exact
        mBCG solves against K_X* for the variance, reusing the cache's
        preconditioner."""
        Xstar = self._tensor(Xstar)
        cache = self.posterior_cache(
            params, data, y, generator=generator, variance_cache=False
        )
        op = self.operator(params, data)
        kern = self.kernel(params)
        cross = self._cross(params, data, Xstar)
        Kxs = cross.to_dense()  # (n, s)
        mean = cross.contract(Kxs.T, cache.alpha)
        solves = bbmm_solve(op, Kxs, self.settings, precond=cache.precond)
        if full_cov:
            return mean, kern(Xstar, Xstar) - Kxs.T @ solves
        # predictive (observation) variance: latent var + likelihood noise
        var = kern.diag(Xstar) - torch.sum(Kxs * solves, dim=0)
        return mean, torch.clamp(var, min=1e-8) + self.noise(params)

    def update_cache(self, params, data, y, cache, X_new, y_new):
        """Streaming append: warm-started CG + Krylov-basis recycling.

        ``data`` / ``y`` are the FULL updated inputs (appended block
        included); the old ``alpha`` seeds the solve and the old basis is
        recycled into the new variance cache — see
        :func:`repro_torch.core.extend_posterior_cache`."""
        return extend_posterior_cache(
            self.operator(params, data), self._tensor(y), cache, self.settings
        )


class WoodburyCache(NamedTuple):
    """Closed-form serving cache for low-rank-root kernels (K̂ = RRᵀ + σ²I).

    Everything a query needs lives in the m-dimensional root coordinates:

      G = RᵀR,  b = Rᵀy                      (sufficient statistics)
      chol = chol(σ²I_m + G)
      w = RᵀK̂⁻¹y = (σ²I_m + G)⁻¹b            (mean weights)
      Luu: maps k(X*, U) into root coordinates (None when the root is
           direct, as BLR's scaled features are)

    (G, b) are additive in the data rows, so an append is an exact rank-k
    refresh: G += RₖᵀRₖ, b += Rₖᵀyₖ, re-derive (:func:`woodbury_update`).

    The reference also keeps H = RᵀK̂⁻¹R, evaluates w and H as
    (b − G·chol⁻¹b)/σ² and (G − G·chol⁻¹G)/σ² and the variance as
    r*ᵀr* − r*ᵀHr*: the same numbers in exact arithmetic, but the
    subtractions cancel ‖G‖/σ² of f32 precision (SGPR at n = 40,000: 4e-4
    of the variance).  Here w and the variance are solves against chol,
    with no subtraction, and H is never needed."""

    G: torch.Tensor  # (m, m)
    b: torch.Tensor  # (m,)
    chol: torch.Tensor  # (m, m)
    w: torch.Tensor  # (m,)
    Luu: torch.Tensor | None  # (m, m) or None
    noise: torch.Tensor  # scalar σ²


def _derive_woodbury(G, b, noise, Luu) -> WoodburyCache:
    m = G.shape[0]
    C = torch.linalg.cholesky(noise * torch.eye(m, dtype=G.dtype, device=G.device) + G)
    w = torch.cholesky_solve(b[:, None], C)[:, 0]
    return WoodburyCache(G=G, b=b, chol=C, w=w, Luu=Luu, noise=noise)


def build_woodbury_cache(R, y, noise, Luu=None) -> WoodburyCache:
    """Exact O(n·m²) Woodbury serving cache from the root R (n, m)."""
    return _derive_woodbury(R.T @ R, R.T @ y, noise, Luu)


def woodbury_update(cache: WoodburyCache, R_new, y_new) -> WoodburyCache:
    """Exact rank-k refresh for k appended rows — O(m³), zero CG, no n."""
    return _derive_woodbury(
        cache.G + R_new.T @ R_new, cache.b + R_new.T @ y_new, cache.noise, cache.Luu
    )


def woodbury_predict(cache: WoodburyCache, Rstar):
    """Mean / variance from the cache for test roots Rstar (s, m) —
    O(s·m²), one triangular solve and no CG.  The latent variance
    r*ᵀr* − r*ᵀHr* is evaluated as σ²·‖chol⁻¹r*‖², without the
    subtraction."""
    mean = Rstar @ cache.w
    V = torch.linalg.solve_triangular(cache.chol, Rstar.T, upper=False)
    var = cache.noise * torch.sum(V * V, dim=0)
    return mean, torch.clamp(var, min=1e-8) + cache.noise


class WoodburyCachePredictor:
    """Serving cache + prediction for low-rank-root models (SGPR, BLR).

    Mixin contract: the model provides ``noise(params)``, ``_tensor(x)``
    and two root hooks —

      * ``_woodbury_root(params, data) -> (R, Luu)`` — the training root
        (n, m) and the triangular map into root coordinates (None when
        roots come directly from inputs);
      * ``_woodbury_root_rows(params, Luu, Xq) -> (q, m)`` — root rows of
        query or appended points.

    The posterior algebra is exact for these kernels, so ``predict`` goes
    through the cache (no CG anywhere) and appends are exact rank-k
    refreshes."""

    def posterior_cache(self, params, data, y) -> WoodburyCache:
        R, Luu = self._woodbury_root(params, data)
        return build_woodbury_cache(R, self._tensor(y), self.noise(params), Luu)

    def predict_cached(self, params, data, cache, Xstar):
        """Mean / variance from the Woodbury cache — O(s·m²), no solves."""
        Rstar = self._woodbury_root_rows(params, cache.Luu, self._tensor(Xstar))
        return woodbury_predict(cache, Rstar)

    def predict(self, params, data, y, Xstar):
        """Predictive mean / variance under the low-rank kernel, through
        :meth:`posterior_cache`: the Woodbury algebra is exact, so no CG
        runs and the mean equals ``predict_cached``'s bit for bit."""
        cache = self.posterior_cache(params, data, y)
        return self.predict_cached(params, data, cache, Xstar)

    def update_cache(self, params, data, y, cache, X_new, y_new):
        """Streaming append: exact rank-k Woodbury refresh — zero CG."""
        R_new = self._woodbury_root_rows(params, cache.Luu, self._tensor(X_new))
        return woodbury_update(cache, R_new, self._tensor(y_new))

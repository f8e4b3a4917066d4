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

:class:`KrylovCachePredictor` implements the three serving methods on top
of the engine: Rayleigh–Ritz variances from an orthonormal Krylov basis.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from repro_torch.core import (
    BBMMSettings,
    build_posterior_cache,
    cached_inv_quad,
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


def missing_protocol_methods(model, methods=PROTOCOL_METHODS) -> list[str]:
    """Names from ``methods`` the model fails to expose as callables."""
    return [m for m in methods if not callable(getattr(model, m, None))]


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

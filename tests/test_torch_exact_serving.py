"""The serving slice end to end: the port's ExactGP against the reference's.

The same numpy data and the same (converted) hyperparameters go through
``posterior_cache`` → ``predict_cached`` and ``predict`` in both packages:
the reference in ``mode="pallas"`` (interpret mode on the CPU) and
``mode="dense"``, the port in ``mode="cuda"`` and ``mode="dense"`` on
``device="cpu"``.  jax and torch draw different numbers from one seed, so
the reference's probes — ``sample_probes(PRNGKey(0), …)``, what its
``posterior_cache`` draws — are handed to the port by monkeypatching the
port's ``sample_probes``.  Tolerances as tests/test_posterior_cache.py:44,65:
mean (and alpha / inv_quad / logdet) rtol 1e-3 / atol 1e-4, variance
rtol 5e-3 / atol 1e-4.

The comparison runs where the answers are determined by the problem rather
than by rounding.  Two correct f32 CG runs that round differently agree to
~5 digits for the first dozen iterations here and then part ways (the port
and the reference reach relative residuals of 1e-4 at different steps; the
reference's own dense and blocked modes do the same at larger n).  So
σ² = 0.5 and cg_tol = 1e-3 stop every column by step ~13, while the two
still agree, and (num_probes + 1)·(max_cg_iters + 1) ≥ n makes the Krylov
basis span ℝⁿ, so the Rayleigh–Ritz variance is exact.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.preconditioner as port_precond
from repro.core import BBMMSettings as RefSettings
from repro.core import build_preconditioner as ref_build_preconditioner
from repro.gp import ExactGP as RefExactGP
from repro_torch import ExactGP, params_from_jax
from repro_torch.core import (
    BBMMSettings,
    SolveFailure,
    SolveHealthWarning,
    cached_mean,
    collect,
)
from repro_torch.core import health
from repro_torch.gp import GPModel, missing_protocol_methods

MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=5e-3, atol=1e-4)
N, D, S = 120, 3, 37
SETTINGS = dict(num_probes=4, max_cg_iters=40, cg_tol=1e-3, precond_rank=5)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) * np.cos(2 * X[:, -1]) + 0.05 * rng.standard_normal(N)).astype(
        np.float32
    )
    Xs = rng.uniform(-1, 1, (S, D)).astype(np.float32)
    return X, y, Xs


def _ref_params(ref_gp, ard, noise=None):
    params = ref_gp.init_params(D, ard=ard)
    if noise is not None:
        params["raw_noise"] = jnp.log(jnp.expm1(jnp.float32(noise)))
    if ard:
        params["raw_lengthscale"] = params["raw_lengthscale"] + jnp.array([0.0, 0.3, -0.2])
    return params


def _inject_reference_probes(monkeypatch, ref_gp, ref_params, X):
    """The port draws exactly the probes the reference's cache build draws."""
    op = ref_gp.operator(ref_params, jnp.asarray(X))
    precond = ref_build_preconditioner(op, ref_gp.settings.precond_rank)
    Z = np.array(precond.sample_probes(jax.random.PRNGKey(0), ref_gp.settings.num_probes, N))

    def sample_probes(self, generator, num, n):
        assert (num, n) == Z.shape[::-1]
        return torch.from_numpy(Z).to(self.L.device)

    monkeypatch.setattr(port_precond.PivotedCholeskyPreconditioner, "sample_probes", sample_probes)
    return Z


def _close(ours, ref, tol):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **tol)


@pytest.mark.parametrize("kernel_type,ard", [("matern52", False), ("rbf", True)])
def test_serving_slice_matches_reference(monkeypatch, kernel_type, ard):
    X, y, Xs = _data()
    refs = {
        mode: RefExactGP(kernel_type=kernel_type, mode=mode, settings=RefSettings(**SETTINGS))
        for mode in ("pallas", "dense")
    }
    ref_params = _ref_params(refs["dense"], ard, noise=0.5)
    _inject_reference_probes(monkeypatch, refs["dense"], ref_params, X)
    params = params_from_jax({k: np.asarray(v) for k, v in ref_params.items()}, device="cpu")

    out = {}
    for mode in ("cuda", "dense"):
        gp = ExactGP(kernel_type=kernel_type, mode=mode, settings=BBMMSettings(**SETTINGS), device="cpu")
        cache = gp.posterior_cache(params, X, y)
        out[mode] = (cache, gp.predict_cached(params, X, cache, Xs), gp.predict(params, X, y, Xs))
    for ref_mode, ref_gp in refs.items():
        Xj, yj, Xsj = jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xs)
        rcache = ref_gp.posterior_cache(ref_params, Xj, yj)
        rmean, rvar = ref_gp.predict_cached(ref_params, Xj, rcache, Xsj)
        pmean, pvar = ref_gp.predict(ref_params, Xj, yj, Xsj)
        for mode, (cache, (mean, var), (umean, uvar)) in out.items():
            assert int(cache.cg_iters.max()) < SETTINGS["max_cg_iters"]  # converged
            np.testing.assert_array_equal(cache.cg_iters.numpy(), np.asarray(rcache.cg_iters))
            _close(cache.alpha, rcache.alpha, MEAN_TOL)
            _close(cache.inv_quad, rcache.inv_quad, MEAN_TOL)
            _close(cache.logdet, rcache.logdet, MEAN_TOL)
            _close(mean, rmean, MEAN_TOL)
            _close(var, rvar, VAR_TOL)
            _close(umean, pmean, MEAN_TOL)
            _close(uvar, pvar, VAR_TOL)
            assert cache.basis.shape == (N, N)  # (t+1)(p+1) ≥ n: full rank


def test_cached_mean_is_the_uncached_mean_and_skips_cg(monkeypatch):
    """predict runs its mean through the cache build's mBCG program, so the
    cached and uncached means are bitwise equal, and predict_cached runs no
    CG at all."""
    import repro_torch.core.inference as inference

    X, y, Xs = _data(1)
    gp = ExactGP(kernel_type="matern52", mode="cuda", settings=BBMMSettings(**SETTINGS), device="cpu")
    params = gp.init_params(X)
    mean_ref, var_ref = gp.predict(params, X, y, Xs)
    calls = {"n": 0}
    real = inference.mbcg

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(inference, "mbcg", counting)
    cache = gp.posterior_cache(params, X, y)
    built = calls["n"]
    for _ in range(3):
        mean, var = gp.predict_cached(params, X, cache, Xs)
    assert built == 1 and calls["n"] == built
    assert torch.equal(mean, mean_ref)
    assert torch.equal(cached_mean(cache, gp.kernel(params)(torch.from_numpy(X), torch.from_numpy(Xs))), mean)
    assert torch.all(var > 0) and torch.all(var >= var_ref - 1e-3)
    # deterministic rebuild: the default generator is seeded
    again = gp.posterior_cache(params, X, y)
    assert torch.equal(again.alpha, cache.alpha) and torch.equal(again.basis, cache.basis)


def test_full_covariance_and_variance_free_cache():
    X, y, Xs = _data(2)
    gp = ExactGP(kernel_type="rbf", mode="cuda", settings=BBMMSettings(**SETTINGS), device="cpu")
    params = gp.init_params(X)
    cache = gp.posterior_cache(params, X, y)
    mean, cov = gp.predict_cached(params, X, cache, Xs[:9], full_cov=True)
    assert cov.shape == (9, 9)
    np.testing.assert_allclose(cov.numpy(), cov.T.numpy(), atol=1e-5)
    lean = gp.posterior_cache(params, X, y, variance_cache=False)
    assert lean.basis is None and torch.isnan(lean.logdet)
    assert torch.equal(lean.alpha, cache.alpha)  # the basis does not change the solve
    with pytest.raises(ValueError, match="variance_cache=False"):
        gp.predict_cached(params, X, lean, Xs)


def test_health_policy_warn_raise_and_reports():
    X, y, Xs = _data(3)
    tight = dict(SETTINGS, max_cg_iters=2)
    gp = ExactGP(kernel_type="matern52", mode="cuda", settings=BBMMSettings(**tight), device="cpu")
    params = gp.init_params(X)
    with collect() as reports, pytest.warns(SolveHealthWarning, match="unhealthy solve"):
        gp.posterior_cache(params, X, y)
    assert len(reports) == 1 and not reports[0].healthy
    assert reports[0].context == "cache_build" and reports[0].duration_s is not None
    strict = ExactGP(
        kernel_type="matern52", mode="cuda", device="cpu",
        settings=BBMMSettings(**dict(tight, on_failure="raise")),
    )
    with pytest.raises(SolveFailure) as err:
        strict.predict(params, X, y, Xs)
    assert err.value.report.status in (health.MAX_ITERS, health.DIVERGED)
    ok = ExactGP(kernel_type="matern52", mode="cuda", settings=BBMMSettings(**SETTINGS), device="cpu")
    with collect() as reports, warnings.catch_warnings():
        warnings.simplefilter("error", SolveHealthWarning)
        ok.predict(params, X, y, Xs)
    assert [r.context for r in reports] == ["cache_build", "solve"]
    assert all(r.healthy for r in reports)


@pytest.mark.parametrize(
    "settings,step",
    [
        (dict(on_failure="degrade"), "step 13"),
        (dict(dense_direct_max_n=500), "step 13"),
    ],
)
def test_unported_settings_raise(settings, step):
    """These settings raised NotImplementedError, naming ROADMAP Queue A
    ``step``, until that step was ported; now they build the cache:
    "degrade" through the ladder (here the initial rung already heals),
    ``dense_direct_max_n`` ≥ n straight through the dense Cholesky (one
    "dense_direct" rung, an exact cache: the identity basis)."""
    X, y, _ = _data(4)
    gp = ExactGP(mode="cuda", settings=BBMMSettings(**dict(SETTINGS, **settings)), device="cpu")
    with collect() as reports:
        cache = gp.posterior_cache(gp.init_params(X), X, y)
    (report,) = reports
    assert report.healthy and report.context == "cache_build", (step, report.describe())
    direct = settings.get("dense_direct_max_n", 0) >= N
    assert [r.rung for r in report.rungs] == (["dense_direct"] if direct else ["initial"])
    if direct:
        assert cache.basis.shape == (N, N)
    assert bool(torch.isfinite(cache.alpha).all())


def test_unported_model_methods_raise():
    """ExactGP exposes the whole GPModel protocol.  Every method of it is
    ported now (the batched engine: tests/test_torch_batched_engine.py;
    streaming: tests/test_torch_serving.py): ``update_cache``, which raised
    naming step 14, extends a cache over appended rows."""
    X, y, _ = _data(5)
    gp = ExactGP(device="cpu", settings=BBMMSettings(**SETTINGS))
    assert isinstance(gp, GPModel) and missing_protocol_methods(gp) == []
    params = gp.init_params(X)
    batch = {k: torch.stack([v, v + 0.1]) for k, v in params.items()}
    assert gp.batched_operator(batch, X).base.batch == 2
    cache = gp.posterior_cache(params, X[:-3], y[:-3])
    new = gp.update_cache(params, X, y, cache, X[-3:], y[-3:])
    assert new.alpha.shape == (N,) and new.basis.shape[0] == N
    assert bool(torch.isfinite(new.alpha).all())


@pytest.mark.parametrize("ard", [False, True])
def test_params_from_jax_carries_the_reference_parameters(ard):
    ref_gp = RefExactGP(kernel_type="matern52")
    ref_params = _ref_params(ref_gp, ard)
    params = params_from_jax({k: np.asarray(v) for k, v in ref_params.items()}, device="cpu")
    gp = ExactGP(kernel_type="matern52", device="cpu")
    k, kr = gp.kernel(params), ref_gp.kernel(ref_params)
    np.testing.assert_allclose(k.lengthscale.numpy(), np.asarray(kr.lengthscale), rtol=1e-6)
    np.testing.assert_allclose(float(k.outputscale), float(kr.outputscale), rtol=1e-6)
    np.testing.assert_allclose(float(gp.noise(params)), float(ref_gp.noise(ref_params)), rtol=1e-6)
    # the reference's own init_params and the port's agree
    np.testing.assert_allclose(
        gp.init_params(D, ard=ard)["raw_lengthscale"].numpy(),
        np.asarray(ref_gp.init_params(D, ard=ard)["raw_lengthscale"]),
        rtol=1e-6,
    )
    with pytest.raises(ValueError, match="ExactGP parameters"):
        params_from_jax({"raw_noise": 0.1}, device="cpu")
    with pytest.raises(ValueError, match="scalar"):
        params_from_jax({**{k: np.asarray(v) for k, v in ref_params.items()},
                         "raw_noise": np.zeros(2)}, device="cpu")

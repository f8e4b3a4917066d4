"""The low-rank-root family: the port's ``LowRankRootOperator``, the
preconditioner's fast path for it, the variational KL, the Woodbury serving
cache, SGPR and Bayesian linear regression against the reference's.

The same numpy data go through both packages, the reference's parameters
carried over by ``params_from_jax(..., model=...)`` (the reference's initial
inducing points included: its ``jax.random.permutation`` cannot be
reproduced by a torch generator).  Every Rademacher draw the port makes is
replayed from the reference's keys by monkeypatching the port's
``_rademacher``, as tests/test_torch_training.py does.

Tolerances: the SoR operator against the dense formula rtol / atol 2e-3
(tests/test_gp_models.py:132); the MLL rtol 1e-4 and each gradient 1e-3 of
its size (tests/test_torch_training.py); KL estimates within 8 % of the
dense KL, ``root_logdet`` rtol 1e-4 (tests/test_variational.py); a
Woodbury append against a rebuild rtol 1e-3 / atol 1e-4
(tests/test_serving.py:192).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.preconditioner as port_precond
from repro.core import AddedDiagOperator as RefAddedDiag
from repro.core import BBMMSettings as RefSettings
from repro.core import DenseOperator as RefDense
from repro.core import LowRankRootOperator as RefLowRank
from repro.core import engine_state as ref_engine_state
from repro.core import gaussian_kl as ref_gaussian_kl
from repro.gp import SGPR as RefSGPR
from repro.gp import BayesianLinearRegression as RefBLR
from repro.gp import build_woodbury_cache as ref_build_woodbury
from repro.gp import woodbury_predict as ref_woodbury_predict
from repro.gp import woodbury_update as ref_woodbury_update
from repro_torch import SGPR, BayesianLinearRegression, gaussian_kl, params_from_jax, root_logdet
from repro_torch.core import (
    AddedDiagOperator,
    BBMMSettings,
    DenseOperator,
    LowRankRootOperator,
    PivotedCholeskyPreconditioner,
    build_preconditioner,
    engine_state,
)
from repro_torch.gp import build_woodbury_cache, woodbury_predict, woodbury_update


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


jax.config.update("jax_platform_name", "cpu")

SOR_TOL = dict(rtol=2e-3, atol=2e-3)
MLL_RTOL = 1e-4
GRAD_RTOL = 1e-3
STREAM_TOL = dict(rtol=1e-3, atol=1e-4)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _toy(seed, n, d=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) * np.cos(2 * X[:, -1]) + 0.05 * rng.standard_normal(n)).astype(
        np.float32)
    return X, y


def _draws(key, rank, n, num):
    """The reference's Rademacher draws for one ``sample_probes(key, …)``."""
    if rank == 0:
        return [np.array(jax.random.rademacher(key, (n, num), dtype=jnp.float32))]
    k1, k2 = jax.random.split(key)
    return [np.array(jax.random.rademacher(k1, (rank, num), dtype=jnp.float32)),
            np.array(jax.random.rademacher(k2, (n, num), dtype=jnp.float32))]


def _replay(monkeypatch, draws):
    queue = list(draws)

    def rademacher(generator, shape, dtype, device):
        g = queue.pop(0)
        assert g.shape == tuple(shape), (g.shape, shape)
        return torch.from_numpy(g).to(device=device, dtype=dtype)

    monkeypatch.setattr(port_precond, "_rademacher", rademacher)
    return queue


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --- LowRankRootOperator ----------------------------------------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "mixed"])
def test_low_rank_root_operator_matches_reference(compute_dtype):
    rng = np.random.default_rng(0)
    R = rng.standard_normal((40, 6)).astype(np.float32)
    M = rng.standard_normal((40, 5)).astype(np.float32)
    op = LowRankRootOperator(torch.from_numpy(R)).with_compute_dtype(compute_dtype)
    ref = RefLowRank(jnp.asarray(R)).with_compute_dtype(compute_dtype)
    out = op.matmul(torch.from_numpy(M)).numpy()
    # both contractions' products are exact (bf16 × bf16 in f32); only the
    # f32 summation order differs between the packages
    np.testing.assert_allclose(out, np.asarray(ref.matmul(jnp.asarray(M))), rtol=1e-5, atol=1e-5)
    dense = R.astype(np.float64) @ R.T.astype(np.float64)
    if compute_dtype == "float32":
        np.testing.assert_allclose(out, dense @ M, rtol=1e-4, atol=1e-4)
        assert op.compute_dtype == "float32"
    else:
        assert op.compute_dtype == "bfloat16"
        assert 0 < _rel(out, dense @ M) < 2e-2  # the policy applied, bf16-close
    np.testing.assert_allclose(op.diagonal().numpy(), np.diagonal(dense), rtol=1e-5)
    np.testing.assert_allclose(op.row(7).numpy(), dense[7], rtol=1e-5, atol=1e-6)
    assert op.matmul(torch.from_numpy(M[:, 0])).shape == (40,)


def test_fast_path_preconditioner_is_the_root(monkeypatch):
    """A low-rank-root base is its own factor whatever the rank: P̂ = K̂, its
    solve is K̂⁻¹ and CG converges in O(1) iterations (the rank-20 pivoted
    Cholesky of the reference's generic path would take ~20); the factor
    carries no gradient."""
    rng = np.random.default_rng(1)
    R = torch.from_numpy(rng.standard_normal((80, 20)).astype(np.float32)).requires_grad_()
    s2 = torch.tensor(0.3, requires_grad=True)
    op = AddedDiagOperator(LowRankRootOperator(R), s2)
    for rank in (1, 5):
        P = build_preconditioner(op, rank)
        assert isinstance(P, PivotedCholeskyPreconditioner)
        assert torch.equal(P.L, R.detach()) and not P.L.requires_grad
        assert not P.sigma2.requires_grad
    B = torch.from_numpy(rng.standard_normal((80, 3)).astype(np.float32))
    dense = (R @ R.T + s2 * torch.eye(80)).detach().double()
    np.testing.assert_allclose(P.solve(B).double().numpy(),
                               torch.linalg.solve(dense, B.double()).numpy(), rtol=1e-3, atol=1e-4)

    settings = BBMMSettings(num_probes=6, max_cg_iters=40, precond_rank=1)
    y = torch.from_numpy(rng.standard_normal(80).astype(np.float32))
    key = jax.random.PRNGKey(3)
    queue = _replay(monkeypatch, _draws(key, 20, 80, 6))
    st = engine_state(op, y, torch.Generator(), settings)
    assert not queue
    rst = ref_engine_state(RefAddedDiag(RefLowRank(jnp.asarray(R.detach().numpy())), 0.3),
                           jnp.asarray(y.numpy()), key,
                           RefSettings(num_probes=6, max_cg_iters=40, precond_rank=1))
    assert int(np.asarray(rst.cg_iters).max()) <= 3
    assert int(st.cg_iters.max()) <= 3, st.cg_iters
    np.testing.assert_allclose(st.solve_y.numpy(), np.asarray(rst.solve_y), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(st.logdet), float(rst.logdet), rtol=1e-4)


# --- variational -------------------------------------------------------------


def _make_cov(rng, n, scale=1.0):
    W = rng.standard_normal((n, n // 2)) * scale
    return (W @ W.T / n + 0.5 * np.eye(n)).astype(np.float32)


def _dense_kl(mu1, S1, mu2, S2):
    S1, S2 = S1.astype(np.float64), S2.astype(np.float64)
    diff = (mu2 - mu1).astype(np.float64)
    return 0.5 * (np.trace(np.linalg.solve(S2, S1)) + diff @ np.linalg.solve(S2, diff)
                  - mu1.shape[0] + np.linalg.slogdet(S2)[1] - np.linalg.slogdet(S1)[1])


def test_gaussian_kl_matches_dense_formula_and_reference(monkeypatch):
    """tests/test_variational.py: one mBCG call against Σ₂ (and one against
    Σ₁ for its log-det) estimates the KL within 8 %; with the reference's
    probes replayed, the port's estimate is the reference's (rtol 1e-4)."""
    n = 60
    rng = np.random.default_rng(0)
    S1, S2 = _make_cov(rng, n), _make_cov(rng, n, 1.3)
    mu1 = rng.standard_normal(n).astype(np.float32)
    mu2 = rng.standard_normal(n).astype(np.float32)
    expected = _dense_kl(mu1, S1, mu2, S2)
    kw = dict(num_probes=64, max_cg_iters=80, precond_rank=0, cg_tol=1e-9)
    # the reference compiled once for the four keys (eager, each call
    # compiles its loops anew: ~24 s against ~6; the same values)
    ref_kl = jax.jit(lambda key: ref_gaussian_kl(
        jnp.asarray(mu1), RefDense(jnp.asarray(S1)), jnp.asarray(mu2), RefDense(jnp.asarray(S2)),
        key, RefSettings(**kw)))
    vals = []
    for i in range(4):
        key = jax.random.PRNGKey(10 + i)
        ref = float(ref_kl(key))
        queue = _replay(monkeypatch, _draws(key, 0, n, 64)
                        + _draws(jax.random.fold_in(key, 1), 0, n, 64))
        ours = float(gaussian_kl(torch.from_numpy(mu1), DenseOperator(torch.from_numpy(S1)),
                                 torch.from_numpy(mu2), DenseOperator(torch.from_numpy(S2)),
                                 torch.Generator(), BBMMSettings(**kw)))
        assert not queue
        np.testing.assert_allclose(ours, ref, rtol=1e-4)
        vals.append(ours)
    assert abs(np.mean(vals) - expected) / abs(expected) < 0.08, (np.mean(vals), expected)


def test_svgp_shaped_kl_with_exact_root_logdet():
    """Σ₁ = RRᵀ + σ²I with its exact log-det (matrix determinant lemma),
    Σ₂ a blackbox: the KL from the port's own probes within 8 %."""
    n, m = 50, 6
    rng = np.random.default_rng(1)
    R = (rng.standard_normal((n, m)) * 0.4).astype(np.float32)
    S2 = _make_cov(rng, n)
    sig2 = 0.3
    ld1 = root_logdet(torch.from_numpy(R), sig2)
    S1 = R.astype(np.float64) @ R.T + sig2 * np.eye(n)
    np.testing.assert_allclose(float(ld1), np.linalg.slogdet(S1)[1], rtol=1e-4)
    from repro.core import root_logdet as ref_root_logdet

    np.testing.assert_allclose(float(ld1), float(ref_root_logdet(jnp.asarray(R), sig2)), rtol=1e-5)
    settings = BBMMSettings(num_probes=64, max_cg_iters=60, precond_rank=0, cg_tol=1e-9)
    S1_op = AddedDiagOperator(LowRankRootOperator(torch.from_numpy(R)), torch.tensor(sig2))
    mu = torch.zeros(n)
    vals = [float(gaussian_kl(mu, S1_op, mu, DenseOperator(torch.from_numpy(S2)),
                              torch.Generator().manual_seed(20 + i), settings, logdet_sigma1=ld1))
            for i in range(4)]
    expected = _dense_kl(np.zeros(n), S1, np.zeros(n), S2.astype(np.float64))
    assert abs(np.mean(vals) - expected) / abs(expected) < 0.08, (np.mean(vals), expected)


# --- Woodbury -------------------------------------------------------------------


def test_woodbury_build_predict_update_match_reference():
    rng = np.random.default_rng(2)
    R = (rng.standard_normal((90, 8)) * 0.5).astype(np.float32)
    y = rng.standard_normal(90).astype(np.float32)
    Rs = (rng.standard_normal((13, 8)) * 0.5).astype(np.float32)
    Rk = (rng.standard_normal((5, 8)) * 0.5).astype(np.float32)
    yk = rng.standard_normal(5).astype(np.float32)
    noise = np.float32(0.2)
    t = torch.from_numpy
    cache = build_woodbury_cache(t(R), t(y), torch.tensor(noise))
    ref = ref_build_woodbury(jnp.asarray(R), jnp.asarray(y), jnp.asarray(noise))
    # the reference's H (RᵀK̂⁻¹R) has no counterpart: the port's variance
    # is a solve against chol, held to the reference's and to f64 below
    for name in ("G", "b", "w"):
        np.testing.assert_allclose(getattr(cache, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    mean, var = woodbury_predict(cache, t(Rs))
    rmean, rvar = ref_woodbury_predict(ref, jnp.asarray(Rs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean), rtol=1e-4, atol=1e-5)
    # the variance is a difference of two O(1) sums, so its f32 rounding
    # shows at the Woodbury tolerance
    np.testing.assert_allclose(var.numpy(), np.asarray(rvar), **STREAM_TOL)
    # the exact posterior of K̂ = RRᵀ + σ²I, in f64
    R64, Rs64 = R.astype(np.float64), Rs.astype(np.float64)
    Khat = R64 @ R64.T + noise * np.eye(90)
    Kxs = R64 @ Rs64.T
    np.testing.assert_allclose(mean.numpy(), Kxs.T @ np.linalg.solve(Khat, y), rtol=1e-4, atol=1e-4)
    exact_var = (np.sum(Rs64 ** 2, 1) - np.sum(Kxs * np.linalg.solve(Khat, Kxs), 0) + noise)
    np.testing.assert_allclose(var.numpy(), exact_var, rtol=1e-4, atol=1e-4)
    # the rank-k refresh against the reference's and against a rebuild
    up = woodbury_update(cache, t(Rk), t(yk))
    rup = ref_woodbury_update(ref, jnp.asarray(Rk), jnp.asarray(yk))
    for name in ("G", "b", "w"):
        np.testing.assert_allclose(getattr(up, name).numpy(), np.asarray(getattr(rup, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    rebuilt = build_woodbury_cache(t(np.concatenate([R, Rk])), t(np.concatenate([y, yk])),
                                   torch.tensor(noise))
    for a, b in zip(woodbury_predict(up, t(Rs)), woodbury_predict(rebuilt, t(Rs))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **STREAM_TOL)


def test_woodbury_cache_does_not_cancel():
    """At ‖G‖/σ² ≈ 10⁴ the reference's (b − G·chol⁻¹b)/σ² and
    r*ᵀr* − r*ᵀHr* lose that much f32 precision (ROADMAP Queue C); the
    port's solves against chol hold the mean and the variance to 1e-4 of
    the f64 posterior."""
    rng = np.random.default_rng(3)
    R = rng.standard_normal((2000, 16)).astype(np.float32)
    y = rng.standard_normal(2000).astype(np.float32)
    Rs = rng.standard_normal((64, 16)).astype(np.float32)
    noise = np.float32(0.2)
    mean, var = woodbury_predict(build_woodbury_cache(torch.from_numpy(R), torch.from_numpy(y),
                                                      torch.tensor(noise)), torch.from_numpy(Rs))
    rmean, rvar = ref_woodbury_predict(
        ref_build_woodbury(jnp.asarray(R), jnp.asarray(y), jnp.asarray(noise)), jnp.asarray(Rs))
    R64, Rs64 = R.astype(np.float64), Rs.astype(np.float64)
    A = R64.T @ R64 + noise * np.eye(16)
    mean64 = Rs64 @ np.linalg.solve(A, R64.T @ y)
    var64 = noise * np.sum(Rs64 * np.linalg.solve(A, Rs64.T).T, 1) + noise
    assert np.linalg.norm(R64.T @ R64, 2) / noise > 5e3
    assert _rel(mean.numpy(), mean64) <= 1e-4 and _rel(var.numpy(), var64) <= 1e-4
    assert _rel(np.asarray(rvar), var64) > 10 * _rel(var.numpy(), var64)


# --- SGPR ---------------------------------------------------------------------


def _sgpr_pair(n=60, m=15, **kw):
    X, y = _toy(5, n)
    ref = RefSGPR(num_inducing=m, **kw)
    rp = ref.init_params(jnp.asarray(X))
    gp = SGPR(num_inducing=m, device="cpu", **kw)
    return X, y, ref, rp, gp, params_from_jax(_np(rp), device="cpu", model="sgpr")


def test_sor_operator_matches_dense_formula_and_reference():
    X, y, ref, rp, gp, params = _sgpr_pair(jitter=1e-5)
    op = gp.operator(params, X)
    assert isinstance(op.base, LowRankRootOperator)
    kern = gp.kernel(params)
    U = params["inducing"].double()
    Kuu = kern(U, U) + 1e-5 * torch.eye(15, dtype=torch.float64)
    Kxu = kern(torch.from_numpy(X).double(), U)
    dense = (Kxu @ torch.linalg.solve(Kuu, Kxu.T)).numpy()
    M = np.random.default_rng(6).standard_normal((60, 3)).astype(np.float32)
    out = op.base.matmul(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(out, dense @ M, **SOR_TOL)
    ref_out = np.asarray(ref.operator(rp, jnp.asarray(X)).base.matmul(jnp.asarray(M)))
    np.testing.assert_allclose(out, ref_out, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(gp.noise(params)), float(ref.noise(rp)), rtol=1e-6)


@pytest.mark.parametrize("precision", ["highest", "mixed"])
def test_sgpr_loss_and_gradients_match_reference(monkeypatch, precision):
    """−MLL and its gradient into every parameter, the inducing points
    included, against ``jax.value_and_grad`` of the reference's loss.
    Under "mixed" the root contractions take bf16 operands in both
    packages and the f32 sums between the roundings differ: the mixed
    tolerances of tests/test_precision.py:137 hold there (the MLL per data
    point within 1e-2, each gradient 1e-2 of its size)."""
    X, y, ref, rp, gp, params = _sgpr_pair(n=150, m=20, precision=precision)
    key = jax.random.PRNGKey(7)
    rloss, rgrads = jax.value_and_grad(ref.loss)(rp, jnp.asarray(X), jnp.asarray(y), key)
    queue = _replay(monkeypatch, _draws(key, 20, 150, gp.settings.num_probes))
    params = {k: v.requires_grad_() for k, v in params.items()}
    loss = gp.loss(params, X, y, torch.Generator())
    loss.backward()
    assert not queue
    if precision == "highest":
        np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=MLL_RTOL)
    else:
        assert abs(float(loss.detach()) - float(rloss)) / 150 <= 1e-2
    for name, p in params.items():
        assert float(p.grad.abs().max()) > 0, name
        assert _rel(p.grad.numpy(), rgrads[name]) <= (GRAD_RTOL if precision == "highest"
                                                      else 1e-2), name


@pytest.mark.parametrize("learn_inducing", [True, False])
def test_sgpr_fit_matches_reference(monkeypatch, learn_inducing):
    """Three Adam steps (lr 0.05) against the reference's fit, each step's
    probes replayed from its key splits; ``learn_inducing=False`` leaves the
    inducing points as they started, bit for bit."""
    X, y, ref, rp, gp, params0 = _sgpr_pair(n=120, m=12)
    ref_params, ref_hist = ref.fit(jnp.asarray(X), jnp.asarray(y), steps=3,
                                   learn_inducing=learn_inducing)
    key, draws = jax.random.PRNGKey(1), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws += _draws(sub, 12, 120, gp.settings.num_probes)
    queue = _replay(monkeypatch, draws)
    monkeypatch.setattr(gp, "init_params", lambda X: params0)
    params, hist = gp.fit(X, y, steps=3, learn_inducing=learn_inducing)
    assert not queue
    np.testing.assert_allclose(hist, ref_hist, rtol=MLL_RTOL)
    for name, v in params.items():
        assert _rel(v.numpy(), ref_params[name]) <= GRAD_RTOL, name
    moved = not torch.equal(params["inducing"], params0["inducing"])
    assert moved == learn_inducing
    if not learn_inducing:
        np.testing.assert_array_equal(params["inducing"].numpy(), np.asarray(rp["inducing"]))


def test_sgpr_predict_matches_reference_and_dense_sor():
    X, y, ref, rp, gp, params = _sgpr_pair(n=80, m=15)
    Xs = np.random.default_rng(9).uniform(-1, 1, (11, 2)).astype(np.float32)
    mean, var = gp.predict(params, X, y, Xs)
    rmean, rvar = ref.predict(rp, jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(rmean), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(rvar), rtol=1e-3, atol=1e-4)
    cache = gp.posterior_cache(params, X, y)
    mean_c, _ = gp.predict_cached(params, X, cache, Xs)
    assert torch.equal(mean_c, mean)


def test_sgpr_init_params_draws_a_training_subset():
    X, _ = _toy(3, 50)
    gp = SGPR(num_inducing=10, device="cpu")
    p = gp.init_params(X)
    U = p["inducing"].numpy()
    assert U.shape == (10, 2)
    assert all(any(np.array_equal(u, x) for x in X) for u in U)
    assert torch.equal(gp.init_params(X)["inducing"], p["inducing"])  # seeded
    other = gp.init_params(X, generator=torch.Generator().manual_seed(1))["inducing"]
    assert not torch.equal(other, p["inducing"])


# --- BLR ----------------------------------------------------------------------


def _blr_data():
    rng = np.random.default_rng(10)
    X = rng.standard_normal((300, 5)).astype(np.float32)
    w = np.array([1.0, -2.0, 0.0, 0.5, 3.0], np.float32)
    y = (X @ w + 0.1 * rng.standard_normal(300)).astype(np.float32)
    return X, y


def test_blr_recovers_weights():
    """tests/test_gp_models.py:176: the fit's loss falls and the posterior
    mean reproduces the targets within 0.2."""
    X, y = _blr_data()
    blr = BayesianLinearRegression(device="cpu")
    params, hist = blr.fit(X, y, steps=60)
    assert hist[-1] < hist[0]
    mean, var = blr.predict(params, X, y, X[:30])
    assert float(torch.mean(torch.abs(mean - torch.from_numpy(y[:30])))) < 0.2
    assert bool(torch.all(var > 0))


def test_blr_loss_gradients_and_posterior_match_reference(monkeypatch):
    X, y = _blr_data()
    ref = RefBLR()
    rp = ref.init_params(jnp.asarray(X))
    rp["raw_prior_scale"] = rp["raw_prior_scale"] + jnp.array([0.0, 0.2, -0.3, 0.1, 0.4])
    blr = BayesianLinearRegression(device="cpu")
    params = {k: v.requires_grad_()
              for k, v in params_from_jax(_np(rp), device="cpu", model="blr").items()}
    key = jax.random.PRNGKey(4)
    rloss, rgrads = jax.value_and_grad(ref.loss)(rp, jnp.asarray(X), jnp.asarray(y), key)
    queue = _replay(monkeypatch, _draws(key, 5, 300, blr.settings.num_probes))
    loss = blr.loss(params, X, y, torch.Generator())
    loss.backward()
    assert not queue
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=MLL_RTOL)
    for name, p in params.items():
        assert _rel(p.grad.numpy(), rgrads[name]) <= GRAD_RTOL, name
    # the posterior: w = (b − G·chol⁻¹b)/σ² cancels ~‖G‖/σ² ≈ 3·10³ here,
    # so both packages' f32 caches lie ~1e-3 from the f64 posterior; the
    # port's may lie no further from it than twice the reference's
    detached = {k: v.detach() for k, v in params.items()}
    mean, var = blr.predict(detached, X, y, X[:20])
    rmean, rvar = ref.predict(rp, jnp.asarray(X), jnp.asarray(y), jnp.asarray(X[:20]))
    R = X.astype(np.float64) * np.log1p(np.exp(np.asarray(rp["raw_prior_scale"], np.float64)))
    noise = float(np.log1p(np.exp(np.float64(rp["raw_noise"]))))
    K = R @ R.T + noise * np.eye(300)
    Kxs = R @ R[:20].T
    mean64 = Kxs.T @ np.linalg.solve(K, y)
    var64 = np.sum(R[:20] ** 2, 1) - np.sum(Kxs * np.linalg.solve(K, Kxs), 0) + noise
    for ours, theirs, exact in ((mean, rmean, mean64), (var, rvar, var64)):
        err, ref_err = (np.abs(np.asarray(a, np.float64) - exact).max() for a in (ours, theirs))
        assert err <= 2 * ref_err + 1e-6, (err, ref_err)


def test_params_from_jax_checks_the_low_rank_layouts():
    with pytest.raises(ValueError, match="SGPR parameters"):
        params_from_jax({"raw_noise": 0.1}, device="cpu", model="sgpr")
    with pytest.raises(ValueError, match="inducing must be a matrix"):
        params_from_jax({"inducing": np.zeros(3), "raw_lengthscale": 0.0,
                         "raw_outputscale": 0.0, "raw_noise": 0.0}, device="cpu", model="sgpr")
    with pytest.raises(ValueError, match="raw_prior_scale must be a vector"):
        params_from_jax({"raw_prior_scale": 1.0, "raw_noise": 0.0}, device="cpu", model="blr")
    with pytest.raises(ValueError, match="SKI parameters"):  # ski is a layout since SKI's port
        params_from_jax({}, device="cpu", model="ski")
    with pytest.raises(ValueError, match="model must be one of"):
        params_from_jax({}, device="cpu", model="svgp")

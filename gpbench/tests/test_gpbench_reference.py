"""The plain reference against dense float64 linear algebra at small n."""

import math

import pytest
import torch

from gpbench.reference import gp as ref

F64 = torch.float64


def problem(n=120, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand((n, d), generator=g, dtype=F64) * 2 - 1
    y = torch.sin(3 * X[:, 0]) * torch.cos(2 * X[:, -1]) + 0.05 * torch.randn(n, generator=g,
                                                                                dtype=F64)
    ell, s, sig2 = (torch.tensor(v, dtype=F64) for v in (0.7, 1.3, 0.2))
    return X, y, ell, s, sig2


def dense(X, ell, s, sig2):
    D = torch.cdist(X / ell, X / ell)
    a = math.sqrt(5.0) * D
    return s * (1 + a + a * a / 3) * torch.exp(-a) + sig2 * torch.eye(X.shape[0], dtype=F64)


def test_kernel_matrix_is_the_matern52_formula():
    X, _, ell, s, sig2 = problem()
    K = ref.KernelMatrix(X, ell, s, sig2)
    M = torch.randn((X.shape[0], 4), generator=torch.Generator().manual_seed(1), dtype=F64)
    Kd = dense(X, ell, s, sig2)
    assert torch.allclose(K.matmul(M), Kd @ M, rtol=1e-10, atol=1e-10)
    assert torch.allclose(ref.KernelMatrix(X, ell, s, sig2, dense=True, block=7).matmul(M),
                          Kd @ M, rtol=1e-10, atol=1e-10)


def test_mbcg_solves_and_tridiagonals():
    X, y, ell, s, sig2 = problem()
    n = X.shape[0]
    Kd = dense(X, ell, s, sig2)
    Z = ref.draw_probes(torch.Generator().manual_seed(3), n, 4, "cpu")
    B = torch.cat([y[:, None], Z], 1)
    U, alphas, betas, actives = ref.mbcg(lambda M: Kd @ M, B, max_iters=n, tol=1e-12)
    assert torch.allclose(U, torch.linalg.solve(Kd, B), rtol=1e-6, atol=1e-8)
    # Lanczos quadrature on a converged run: zᵀ log(K̂) z for each probe
    evals, evecs = torch.linalg.eigh(Kd)
    logK = evecs @ torch.diag(torch.log(evals)) @ evecs.T
    want = torch.mean(torch.einsum("nt,nm,mt->t", Z, logK, Z))
    got = ref.slq_logdet(alphas[1:], betas[1:], actives[1:], Z)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_gradient_is_the_bbmm_estimator():
    """With converged solves the estimator is −½uᵀ∂K̂u + (1/2t)Σ zᵢᵀ∂K̂K̂⁻¹zᵢ."""
    X, y, _, _, _ = problem(n=80)
    raw = {k: torch.tensor(ref.inv_softplus(v), dtype=F64)
           for k, v in zip(ref.LEAVES, (0.7, 1.3, 0.2))}
    Z = ref.draw_probes(torch.Generator().manual_seed(4), 80, 3, "cpu")
    loss, grads = ref.loss_and_grad(X, y, raw, Z, max_iters=80, tol=1e-12, block=33)
    leaves = {k: v.clone().requires_grad_() for k, v in raw.items()}
    Kd = dense(X, *(ref.softplus(leaves[k]) for k in ref.LEAVES))
    u = torch.linalg.solve(Kd.detach(), y)
    S = torch.linalg.solve(Kd.detach(), Z)
    surrogate = 0.5 * (-(u @ Kd @ u) + (Z * (Kd @ S)).sum() / Z.shape[1])
    want = torch.autograd.grad(surrogate, [leaves[k] for k in ref.LEAVES])
    for k, w in zip(ref.LEAVES, want):
        assert float(grads[k]) == pytest.approx(float(w), rel=1e-6, abs=1e-9)
    n = 80
    exact_iq = float(y @ u)
    assert loss > 0.5 * (exact_iq + n * math.log(2 * math.pi)) - 1e3  # finite and sized


def test_adam_is_the_textbook_update():
    X, y, _, _, _ = problem(n=60)
    raw0 = {k: torch.tensor(ref.inv_softplus(v), dtype=F64) for k, v in
            zip(ref.LEAVES, (0.5, 1.0, 0.1))}
    out = ref.train_reference(X, y, raw0, torch.Generator().manual_seed(5), steps=2, lr=0.1,
                              num_probes=3, max_iters=60, tol=1e-12, dense=False)
    g1 = out["grads"][0]
    for k in ref.LEAVES:  # Adam's first step moves every leaf by lr against its sign
        step1 = float(out["params"][0][k] - raw0[k])
        assert step1 == pytest.approx(-0.1 * math.copysign(1.0, float(g1[k])), rel=1e-6)


def test_preconditioned_weights_and_cached_answer():
    X, y, ell, s, sig2 = problem()
    n = X.shape[0]
    Kd = dense(X, ell, s, sig2)
    alpha = ref.posterior_weights(X, y, ell, s, sig2, rank=5, jitter=1e-8, max_iters=n,
                                  tol=1e-12, dense=False)
    assert torch.allclose(alpha, torch.linalg.solve(Kd, y), rtol=1e-6, atol=1e-8)
    # warm-started from a perturbed start, the append reaches the same solve
    u0 = alpha + 1e-3 * torch.randn(n, generator=torch.Generator().manual_seed(6), dtype=F64)
    again = ref.posterior_weights(X, y, ell, s, sig2, rank=5, jitter=1e-8, max_iters=n,
                                  tol=1e-12, u0=u0)
    assert torch.allclose(again, alpha, rtol=1e-6, atol=1e-8)
    # with the full basis the cached answer is the exact posterior
    Xs = torch.rand((7, X.shape[1]), generator=torch.Generator().manual_seed(7), dtype=F64)
    mean, var = ref.cached_answer(X, Xs, ell, s, sig2, alpha, torch.eye(n, dtype=F64),
                                  torch.linalg.cholesky(Kd))
    Kxs = ref.KernelMatrix(X, ell, s, sig2).cross(X, Xs)
    assert torch.allclose(mean, Kxs.T @ torch.linalg.solve(Kd, y), rtol=1e-6, atol=1e-9)
    exact = s - (Kxs * torch.linalg.solve(Kd, Kxs)).sum(0) + sig2
    assert torch.allclose(var, exact, rtol=1e-6, atol=1e-9)
    G = ref.build_gram(X, ell, s, sig2, torch.eye(n, dtype=F64)[:, :10])
    assert torch.allclose(G, Kd[:10, :10] + 1e-6 * torch.trace(Kd[:10, :10]) / 10
                          * torch.eye(10, dtype=F64), rtol=1e-10)


def test_pivoted_cholesky_matches_dense():
    X, _, ell, s, sig2 = problem(n=50)
    K = ref.KernelMatrix(X, ell, s, sig2)
    L = ref.pivoted_cholesky(K, 50, jitter=1e-12)
    Kb = dense(X, ell, s, torch.tensor(0.0, dtype=F64))
    assert torch.allclose(L @ L.T, Kb, atol=1e-8)
    assert int(torch.argmax(torch.zeros(50))) == 0  # the first pivot is the first maximum


@pytest.mark.parametrize("rounding, rel", [("tf32", 2.0 ** -11), ("fp8", 2.0 ** -4)])
def test_control_roundings(rounding, rel):
    x = torch.linspace(-3, 3, 1001, dtype=F64)
    r = ref.ROUNDINGS[rounding](x)
    err = (r - x).abs() / x.abs().clamp(min=1e-12)
    big = x.abs() > 0.05
    assert float(err[big].max()) <= rel * 1.0001
    assert float(err[big].max()) > rel / 4  # it does lower the precision
    assert torch.equal(ref.round_tf32(torch.tensor([1.0, 0.5, -2.0])), torch.tensor([1.0, 0.5, -2.0]))

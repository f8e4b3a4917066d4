"""The port's batched engine against the reference's (tests/test_batched_engine.py):
one (b, n, t) engine call must match a Python loop of single calls — the
multi-restart path (``BatchDenseOperator``, ``ExactGP.batched_loss``) and
the multi-output path (one kernel operator, y of shape (b, n); on the GPU
its product is B2, its gradient one gradient-kernel launch).

The same numpy inputs go to both packages; where the engine draws probes,
the reference's ``sample_probes(key, …)`` are handed to the port by
monkeypatching its preconditioners' ``sample_probes``.  Tolerances are the
reference test's: solves rtol 1e-5 / atol 1e-6, MLL 1e-5 relative,
gradients rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.preconditioner as port_precond
from repro.core import AddedDiagOperator as RefAddedDiag
from repro.core import BatchDenseOperator as RefBatchDense
from repro.core import BBMMSettings as RefSettings
from repro.core import build_preconditioner as ref_build_preconditioner
from repro.core import marginal_log_likelihood as ref_mll
from repro.core import mbcg as ref_mbcg
from repro.gp import ExactGP as RefExactGP
from repro_torch import ExactGP
from repro_torch.core import (
    AddedDiagOperator,
    BatchDenseOperator,
    BBMMSettings,
    DenseOperator,
    inv_quad_logdet,
    marginal_log_likelihood,
    mbcg,
    tridiag_matrices,
)
from repro_torch.gp import KernelOperator, RBFKernel


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


jax.config.update("jax_platform_name", "cpu")

SOLVE_TOL = dict(rtol=1e-5, atol=1e-6)
MLL_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# The port against the reference: the same numbers over a CG prefix.  On
# this problem (ℓ up to 0.5 on 80 points in [0, 1], σ² down to 0.05) the
# Krylov spaces are exhausted to f32 rounding within a few iterations; past
# that two correct f32 runs part (ROADMAP Queue C item 3: at 5 iterations
# the two packages' Lanczos β differ by 16, their MLL by 4e-5 relative; at
# 3 their log-dets by 7e-7), so the batched-vs-loop checks run the
# reference test's 40 iterations and the cross-package ones this many.
PREFIX_ITERS = 3


def rbf_K(x, ell):
    return np.exp(-((x[:, None] - x[None, :]) ** 2) / (2 * ell**2)).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n = 80
    x = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    y = np.sin(6 * x).astype(np.float32)
    ells = np.array([0.1, 0.2, 0.35, 0.5], np.float32)
    noises = np.array([0.05, 0.1, 0.05, 0.2], np.float32)
    Ks = np.stack([rbf_K(x, e) for e in ells])
    return x, y, ells, noises, Ks


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _inject_probes(monkeypatch, Z):
    """The port's engine draws exactly ``Z`` (the reference's probes)."""

    def sample_probes(self, generator, num, n):
        assert (num, n) == (Z.shape[-1], Z.shape[-2])
        return torch.from_numpy(np.array(Z))

    for cls in (port_precond.PivotedCholeskyPreconditioner, port_precond.IdentityPreconditioner):
        monkeypatch.setattr(cls, "sample_probes", sample_probes)


def _ref_probes(ref_op, settings, key, n):
    precond = ref_build_preconditioner(ref_op, settings.precond_rank)
    return np.array(precond.sample_probes(key, settings.num_probes, n))


class TestBatchedMBCG:
    def test_batched_solves_match_loop(self, problem):
        x, y, ells, noises, Ks = problem
        A = Ks + noises[:, None, None] * np.eye(80, dtype=np.float32)
        B = np.random.default_rng(1).standard_normal((4, 80, 5)).astype(np.float32)
        res = mbcg(lambda M: _t(A) @ M, _t(B), max_iters=80, tol=1e-10)
        assert res.solves.shape == (4, 80, 5)
        for i in range(4):
            ri = mbcg(DenseOperator(_t(A[i])).matmul, _t(B[i]), max_iters=80, tol=1e-10)
            np.testing.assert_allclose(res.solves[i], ri.solves, **SOLVE_TOL)
            np.testing.assert_allclose(res.tridiag_alpha[i], ri.tridiag_alpha, rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(tridiag_matrices(res)[i], tridiag_matrices(ri), **SOLVE_TOL)
        # the reference's batched solve of the same system, over a prefix:
        # at ℓ = 0.5 the Krylov space is exhausted to f32 rounding after ~5
        # iterations, past which two correct f32 runs part (the reference's
        # own 6th α lies 3.8 from f64's, the port's 1.2; ROADMAP Queue C
        # item 3)
        res4 = mbcg(lambda M: _t(A) @ M, _t(B), max_iters=4, tol=1e-10)
        rres = ref_mbcg(lambda M: jnp.asarray(A) @ M, jnp.asarray(B), max_iters=4, tol=1e-10)
        # (atol 1e-5 of solves of size ~10: two f32 matmul orders)
        np.testing.assert_allclose(res4.solves, np.asarray(rres.solves), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res4.tridiag_alpha, np.asarray(rres.tridiag_alpha),
                                   rtol=1e-5, atol=1e-7)

    def test_batched_masking_per_problem(self):
        """Convergence masking is per (batch, column): an easy problem in the
        batch freezes early while a hard one keeps iterating."""
        rng = np.random.default_rng(2)
        n = 64
        easy = 10.0 * np.eye(n, dtype=np.float32)
        x = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
        hard = rbf_K(x, 0.1) + 0.01 * np.eye(n, dtype=np.float32)
        A = np.stack([easy, hard])
        B = rng.standard_normal((2, n, 3)).astype(np.float32)
        res = mbcg(lambda M: _t(A) @ M, _t(B), max_iters=40, tol=1e-6)
        assert int(res.num_iters[0].max()) <= 2
        assert int(res.num_iters[1].min()) > 5
        np.testing.assert_allclose(res.solves[0], B[0] / 10.0, rtol=1e-6)
        rres = ref_mbcg(lambda M: jnp.asarray(A) @ M, jnp.asarray(B), max_iters=40, tol=1e-6)
        np.testing.assert_array_equal(res.num_iters.numpy()[0], np.asarray(rres.num_iters)[0])


class TestBatchedMLL:
    @pytest.mark.parametrize("rank", [0, 5])
    def test_matches_loop_of_unbatched(self, monkeypatch, problem, rank):
        """The batched MLL over b = 4 hyperparameter sets is the loop of
        unbatched calls with the same probes (≤ 1e-5), and the reference's
        batched MLL on the same probes."""
        x, y, ells, noises, Ks = problem
        s = BBMMSettings(num_probes=8, max_cg_iters=40, precond_rank=rank)
        key = jax.random.PRNGKey(7)
        ref_op = RefAddedDiag(RefBatchDense(jnp.asarray(Ks)), jnp.asarray(noises))
        Z = _ref_probes(ref_op, RefSettings(num_probes=8, precond_rank=rank), key, 80)
        _inject_probes(monkeypatch, Z)
        op = AddedDiagOperator(BatchDenseOperator(_t(Ks)), _t(noises))
        yb = _t(y).expand(4, 80)
        batched = marginal_log_likelihood(op, yb, torch.Generator(), s)
        assert batched.shape == (4,)
        short = BBMMSettings(num_probes=8, max_cg_iters=PREFIX_ITERS, precond_rank=rank)
        ref = ref_mll(ref_op, jnp.broadcast_to(jnp.asarray(y), (4, 80)), key,
                      RefSettings(num_probes=8, max_cg_iters=PREFIX_ITERS, precond_rank=rank))
        np.testing.assert_allclose(marginal_log_likelihood(op, yb, torch.Generator(), short).numpy(),
                                   np.asarray(ref), rtol=MLL_RTOL)
        loop = []
        for i in range(4):
            _inject_probes(monkeypatch, Z[i] if Z.ndim == 3 else Z)
            loop.append(marginal_log_likelihood(
                AddedDiagOperator(DenseOperator(_t(Ks[i])), _t(noises[i])), _t(y),
                torch.Generator(), s,
            ))
        loop = torch.stack(loop)
        err = float((batched - loop).abs().max() / loop.abs().max())
        assert err <= MLL_RTOL, (rank, err)

    def test_batched_gradients_match_loop(self, monkeypatch, problem):
        x, y, ells, noises, Ks = problem
        s = BBMMSettings(num_probes=8, max_cg_iters=40, precond_rank=0)
        key = jax.random.PRNGKey(8)
        Z = np.array(jax.random.rademacher(key, (80, 8), dtype=jnp.float32))
        _inject_probes(monkeypatch, Z)
        xt = _t(x)

        def K_of(e):
            return torch.exp(-((xt[:, None] - xt[None, :]) ** 2) / (2 * e**2))

        e_b = _t(ells).clone().requires_grad_()
        mll = marginal_log_likelihood(
            AddedDiagOperator(BatchDenseOperator(torch.stack([K_of(e) for e in e_b])),
                              _t(noises)),
            _t(y).expand(4, 80), torch.Generator(), s,
        )
        (g_b,) = torch.autograd.grad(mll.sum(), e_b)
        g_l = []
        for i in range(4):
            e = _t(ells[i]).clone().requires_grad_()
            m = marginal_log_likelihood(AddedDiagOperator(DenseOperator(K_of(e)), _t(noises[i])),
                                        _t(y), torch.Generator(), s)
            g_l.append(torch.autograd.grad(m, e)[0])
        np.testing.assert_allclose(g_b.numpy(), torch.stack(g_l).numpy(), **GRAD_TOL)

        # the reference's jax.grad of the same (b,) sum on the same probes,
        # over the prefix
        xj = jnp.asarray(x)

        def ref_sum(e):
            Kb = jax.vmap(lambda ell: jnp.exp(-((xj[:, None] - xj[None, :]) ** 2) / (2 * ell**2)))(e)
            return jnp.sum(ref_mll(RefAddedDiag(RefBatchDense(Kb), jnp.asarray(noises)),
                                   jnp.broadcast_to(jnp.asarray(y), (4, 80)), key,
                                   RefSettings(num_probes=8, max_cg_iters=PREFIX_ITERS,
                                               precond_rank=0)))

        e_b = _t(ells).clone().requires_grad_()
        short = BBMMSettings(num_probes=8, max_cg_iters=PREFIX_ITERS, precond_rank=0)
        mll = marginal_log_likelihood(
            AddedDiagOperator(BatchDenseOperator(torch.stack([K_of(e) for e in e_b])),
                              _t(noises)),
            _t(y).expand(4, 80), torch.Generator(), short,
        )
        (g_short,) = torch.autograd.grad(mll.sum(), e_b)
        np.testing.assert_allclose(g_short.numpy(),
                                   np.asarray(jax.grad(ref_sum)(jnp.asarray(ells))), **GRAD_TOL)

    def test_batched_inv_quad_logdet_shapes(self, problem):
        x, y, ells, noises, Ks = problem
        s = BBMMSettings(num_probes=8, max_cg_iters=40, precond_rank=5)
        g = torch.Generator()
        g.manual_seed(9)
        iq, ld = inv_quad_logdet(AddedDiagOperator(BatchDenseOperator(_t(Ks)), _t(noises)),
                                 _t(y).expand(4, 80), g, s)
        assert iq.shape == (4,) and ld.shape == (4,)
        assert bool(torch.isfinite(iq).all()) and bool(torch.isfinite(ld).all())

    def test_exactgp_batched_loss(self, monkeypatch, problem):
        """``ExactGP.batched_loss`` against a loop of ``loss`` and against the
        reference's ``batched_loss`` on the same probes."""
        x, y, *_ = problem
        X = x[:, None]
        settings = dict(num_probes=8, max_cg_iters=40)
        ref_gp = RefExactGP(settings=RefSettings(**settings))
        p0 = ref_gp.init_params(1)
        ref_batch = jax.tree.map(lambda v: jnp.stack([v, v + 0.3, v - 0.2, v + 0.1]), p0)
        key = jax.random.PRNGKey(11)
        ref_op = ref_gp.batched_operator(ref_batch, jnp.asarray(X))
        Z = _ref_probes(ref_op, RefSettings(**settings), key, 80)
        _inject_probes(monkeypatch, Z)
        gp = ExactGP(settings=BBMMSettings(**settings), device="cpu")
        batch = {k: _t(v) for k, v in ref_batch.items()}
        lb = gp.batched_loss(batch, X, y, torch.Generator())
        assert lb.shape == (4,)
        ref = np.asarray(ref_gp.batched_loss(ref_batch, jnp.asarray(X), jnp.asarray(y), key))
        np.testing.assert_allclose(lb.detach().numpy(), ref, rtol=MLL_RTOL)
        loop = []
        for i in range(4):
            _inject_probes(monkeypatch, Z[i])
            loop.append(gp.loss({k: v[i] for k, v in batch.items()}, X, y, torch.Generator()))
        np.testing.assert_allclose(lb.detach().numpy(), torch.stack(loop).detach().numpy(),
                                   rtol=MLL_RTOL)


def test_batched_preconditioner_pivots_as_the_loop(problem):
    """``ExactGP.batched_operator`` hands the kernels' exact diagonals
    k(x, x) to ``BatchDenseOperator``, so its pivoted-Cholesky factors are
    a loop's (``operator`` per set pivots on ``KernelOperator.diagonal()``)
    even where the materialized diagonal carries rounding, which would
    break k(x, x)'s ties elsewhere."""
    x, *_ = problem
    X = _t(x[:, None].copy())
    gp = ExactGP(mode="dense", settings=BBMMSettings(precond_rank=5), device="cpu")
    p0 = gp.init_params(X)
    batch = {k: torch.stack([v, v + 0.3, v - 0.2, v + 0.1]) for k, v in p0.items()}
    op = gp.batched_operator(batch, X)
    L = port_precond.build_preconditioner(op, 5).L
    for i in range(4):
        loop = gp.operator({k: v[i] for k, v in batch.items()}, X)
        torch.testing.assert_close(L[i], port_precond.build_preconditioner(loop, 5).L,
                                   rtol=1e-5, atol=1e-6)
    # one diagonal entry rounded up by 1e-6, as a distance expansion leaves it
    K = op.base.matrices.clone()
    K[:, 7, 7] += 1e-6
    given = AddedDiagOperator(BatchDenseOperator(K, diag=op.base.diag), op.sigma2)
    read = AddedDiagOperator(BatchDenseOperator(K), op.sigma2)
    first_pivot = lambda o: port_precond.build_preconditioner(o, 5).L[:, :, 0].argmax(-1)  # noqa: E731
    assert first_pivot(given).tolist() == [0] * 4  # k(x, x)'s ties: the first row
    assert first_pivot(read).tolist() == [7] * 4


def _multi_output_problem(b=4, n=96, d=3):
    rng = np.random.default_rng(3)
    X = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    Y = np.stack([np.sin(3 * X[:, 0] + k) * np.cos(2 * X[:, -1]) for k in range(b)])
    Y = (Y + 0.05 * rng.standard_normal((b, n))).astype(np.float32)
    return X, Y


@pytest.mark.parametrize("mode,fuse", [("cuda", False), ("cuda", True), ("dense", False)])
def test_multi_output_mll_and_gradients_match_reference(monkeypatch, mode, fuse):
    """A multi-output MLL — one kernel operator, y of shape (b, n), one
    engine call — against the reference's: the (b,) values and the
    hyperparameter gradients of their sum (``jax.grad``), on the same
    probes.  Through ``KernelOperator(mode="cuda")`` on the CPU this runs
    the batched product's autograd Function (B2's on the card) and its
    folded backward; fused, the batched fused step (B3 with b = 4).  At
    ``precond_rank=0``: the reference's shared preconditioner cannot solve
    a batched right-hand side (its ``cho_solve`` takes no batch dims), so
    the preconditioned multi-output engine is held to a loop below.
    Tolerances: MLL rtol 1e-4, gradients rtol 2e-3 / atol 1e-4
    (tests/test_fused_cg.py:309-311)."""
    X, Y = _multi_output_problem()
    n, d = X.shape
    settings = dict(num_probes=6, max_cg_iters=30, precond_rank=0)
    ref_gp = RefExactGP(kernel_type="matern52", mode="dense", settings=RefSettings(**settings))
    ref_params = ref_gp.init_params(d, ard=True)
    ref_params["raw_lengthscale"] = ref_params["raw_lengthscale"] + jnp.array([0.0, 0.3, -0.2])
    key = jax.random.PRNGKey(5)
    Z = _ref_probes(ref_gp.operator(ref_params, jnp.asarray(X)), RefSettings(**settings), key, n)
    _inject_probes(monkeypatch, Z)

    ref_each, ref_grads = jax.value_and_grad(
        lambda p: jnp.sum(ref_gp.loss(p, jnp.asarray(X), jnp.asarray(Y), key))
    )(ref_params)
    ref_each = np.asarray(ref_gp.loss(ref_params, jnp.asarray(X), jnp.asarray(Y), key))
    gp = ExactGP(kernel_type="matern52", mode=mode, fuse_cg=fuse,
                 settings=BBMMSettings(**settings), device="cpu")
    params = {k: _t(v).clone().requires_grad_() for k, v in ref_params.items()}
    loss = gp.loss(params, X, Y, torch.Generator())
    assert loss.shape == (4,)
    np.testing.assert_allclose(loss.detach().numpy(), ref_each, rtol=1e-4)
    loss.sum().backward()
    for k, v in params.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(ref_grads[k]), rtol=2e-3, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("fuse", [False, True])
def test_multi_output_matches_a_loop_of_single_outputs(fuse):
    """The multi-output engine (one call over (4, n, t), the probes shared)
    is the loop of 4 single-output calls from the same generator: the (4,)
    MLL within 1e-5, the gradients of its sum at rtol 1e-4 / atol 1e-5 —
    unfused at ``precond_rank=5`` (one shared preconditioner for the
    batch), fused at ``precond_rank=0``."""
    X, Y = _multi_output_problem()
    settings = BBMMSettings(num_probes=6, max_cg_iters=30, precond_rank=0 if fuse else 5)
    gp = ExactGP(kernel_type="matern52", mode="cuda", fuse_cg=fuse, settings=settings,
                 device="cpu")
    p0 = gp.init_params(X.shape[1], ard=True)

    def gen():
        g = torch.Generator()
        g.manual_seed(4)
        return g

    params = {k: v.clone().requires_grad_() for k, v in p0.items()}
    loss = gp.loss(params, X, Y, gen())
    loss.sum().backward()
    loop, grads = [], {k: torch.zeros_like(v) for k, v in p0.items()}
    for i in range(4):
        pi = {k: v.clone().requires_grad_() for k, v in p0.items()}
        li = gp.loss(pi, X, Y[i], gen())
        li.backward()
        loop.append(li.detach())
        for k in grads:
            grads[k] += pi[k].grad
    np.testing.assert_allclose(loss.detach().numpy(), torch.stack(loop).numpy(), rtol=MLL_RTOL)
    for k, v in params.items():
        np.testing.assert_allclose(v.grad.numpy(), grads[k].numpy(), **GRAD_TOL, err_msg=k)


def test_batched_kernel_product_gradient_folds_the_batch():
    """The batched product's backward (the B2 repair): one K shared by b
    right-hand sides, so its gradient for X, the outputscale and σ² is the
    sum over the batch of the 2-D gradients — here folded into one call
    over (n, b·t) — for one X on both sides and for a row slice with a
    row offset."""
    from repro_torch.kernels.kernel_matmul.ops import fused_kernel_matmul_prescaled
    from repro_torch.kernels.kernel_matmul.ref import kernel_matmul_grad_plain

    rng = np.random.default_rng(4)
    n, d, b, t = 70, 3, 3, 5
    X = _t(rng.standard_normal((n, d)).astype(np.float32))
    M = _t(rng.standard_normal((b, n, t)).astype(np.float32))
    C = _t(rng.standard_normal((b, n, t)).astype(np.float32))
    for rows, off in ((n, 0), (30, 17)):
        Xg = X.clone().requires_grad_()
        s = torch.tensor(1.3, requires_grad=True)
        s2 = torch.tensor(0.2, requires_grad=True)
        Xr = Xg if rows == n else Xg[off : off + rows]
        out = fused_kernel_matmul_prescaled(Xr, Xg, M, s, s2, off, kernel_type="matern52")
        got = torch.autograd.grad(out, (Xg, s, s2), C[:, :rows])
        want = [torch.zeros_like(X), torch.zeros(()), torch.zeros(())]
        for i in range(b):
            g1, g2, gs, gs2 = kernel_matmul_grad_plain(X[off : off + rows], X, M[i], C[i, :rows],
                                                       1.3, 0.2, off, kernel_type="matern52")
            want[0][off : off + rows] += g1
            want[0] += g2
            want[1] += gs
            want[2] += gs2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-4, atol=1e-5)


def test_multi_output_engine_state_and_solve_take_a_batch():
    """``engine_state`` with y (b, n) and ``solve`` with B (b, n, t) on one
    kernel operator: batched shapes, and each batch element the single
    call's answer."""
    from repro_torch.core import engine_state, solve

    rng = np.random.default_rng(6)
    n, d, b = 90, 2, 3
    X = _t(rng.uniform(-1, 1, (n, d)).astype(np.float32))
    Y = _t(rng.standard_normal((b, n)).astype(np.float32))
    kern = RBFKernel(lengthscale=torch.tensor(0.4), outputscale=torch.tensor(1.0))
    op = AddedDiagOperator(KernelOperator(kernel=kern, X=X, mode="cuda"), torch.tensor(0.3))
    s = BBMMSettings(num_probes=4, max_cg_iters=60, cg_tol=1e-6, precond_rank=5)

    def gen():
        g = torch.Generator()
        g.manual_seed(1)
        return g

    st = engine_state(op, Y, gen(), s)
    assert st.solve_y.shape == (b, n) and st.inv_quad.shape == (b,) and st.logdet.shape == (b,)
    assert st.probe_solves.shape == (b, n, 4)
    for i in range(b):
        si = engine_state(op, Y[i], gen(), s)
        np.testing.assert_allclose(st.solve_y[i].numpy(), si.solve_y.numpy(), **SOLVE_TOL)
        np.testing.assert_allclose(float(st.logdet[i]), float(si.logdet), rtol=1e-5)
    B = _t(rng.standard_normal((b, n, 2)).astype(np.float32))
    U = solve(op, B, s)
    assert U.shape == (b, n, 2)
    np.testing.assert_allclose(op.matmul(U).numpy(), B.numpy(), rtol=1e-3, atol=1e-3)

"""The multitask GP: the port's Kronecker / Hadamard / per-task-noise
operators and ``MultitaskGP`` against the reference's (counterparts of
tests/test_multitask.py:75-547).

The same numpy panels go through both packages; the reference's parameters
carry over by ``params_from_jax(..., model="multitask")`` and its
Rademacher draws are replayed into the port (multitask solves run at
``precond_rank=0``, so one draw per engine call).  ``mode="cuda"`` on CPU
tensors runs the kernel wrappers' plain versions: the data matmul at T·t
stacked columns and its gradient through the symmetric VJP's plain
version.

Tolerances: operators against the dense (nT × nT) matrix rtol 1e-4 /
atol 1e-4 (tests/test_multitask.py:89), solves rtol 1e-3 / atol 1e-4
(:130); the posterior against the dense Cholesky posterior 1e-4 (:352);
the averaged BBMM gradient within 0.1 of the Cholesky gradient (:303); the
MLL against the reference rtol 1e-4 and each gradient 1e-3 of its size
(tests/test_torch_training.py); a streamed session within rtol 1e-3 /
atol 1e-4 of a rebuild, its variance conservative to 1e-4 (:509-510).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.preconditioner as port_precond
from repro.core import BBMMSettings as RefSettings
from repro.gp import MultitaskGP as RefMultitaskGP
from repro.gp import to_long_format as ref_to_long_format
from repro_torch import MultitaskGP, params_from_jax
from repro_torch.core import (
    BBMMSettings,
    HadamardKroneckerOperator,
    KroneckerAddedDiagOperator,
    KroneckerKernelOperator,
    build_preconditioner,
    solve,
    tensor_leaves,
)
from repro_torch.gp import (
    DeepKernel,
    KernelOperator,
    RBFKernel,
    fit_gp,
    missing_protocol_methods,
    split_long_format,
    supports_streaming,
    to_long_format,
)
from repro_torch.serving import PosteriorSession, fingerprint


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


jax.config.update("jax_platform_name", "cpu")

SET = BBMMSettings(num_probes=4, max_cg_iters=80, cg_tol=1e-7, precond_rank=0)
OP_TOL = dict(rtol=1e-4, atol=1e-4)
MLL_RTOL = 1e-4
GRAD_RTOL = 1e-3
PARITY = dict(num_probes=4, max_cg_iters=40, cg_tol=1e-3, precond_rank=0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def grid_problem(seed, n=10, T=3, d=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d)).astype(np.float32)
    latent = np.sin(3.0 * X[:, :1])
    Y = latent * (1.0 + 0.3 * np.arange(T)) + 0.1 * rng.standard_normal((n, T))
    return to_long_format(X, Y)


def task_matrix(rng, T):
    B = 0.5 * rng.standard_normal((T, 2))
    return torch.from_numpy((B @ B.T + np.diag(0.5 + 0.1 * np.arange(T))).astype(np.float32))


def _kern(ell=0.5, s=1.3):
    return RBFKernel(lengthscale=torch.tensor(ell), outputscale=torch.tensor(s))


def kron_reference(kern, X, KT, noise=None):
    """The dense multitask covariance (data-major), in f64."""
    K = np.kron(kern(X, X).double().numpy(), KT.double().numpy())
    if noise is not None:
        K = K + np.diag(np.tile(noise.double().numpy(), X.shape[0]))
    return K


def _draws(key, m, num):
    return [np.array(jax.random.rademacher(key, (m, num), dtype=jnp.float32))]


def _replay(monkeypatch, draws):
    queue = list(draws)

    def rademacher(generator, shape, dtype, device):
        g = queue.pop(0)
        assert g.shape == tuple(shape), (g.shape, shape)
        return torch.from_numpy(g).to(device=device, dtype=dtype)

    monkeypatch.setattr(port_precond, "_rademacher", rademacher)
    return queue


def _gp(**kw):
    kw.setdefault("settings", SET)
    return MultitaskGP(device="cpu", **kw)


class TestKroneckerOperator:
    def setup_method(self):
        rng = np.random.default_rng(0)
        self.n, self.T = 9, 3
        self.X = torch.from_numpy(rng.uniform(0, 1, (self.n, 2)).astype(np.float32))
        self.kern = _kern()
        self.KT = task_matrix(rng, self.T)
        self.op = KroneckerKernelOperator(KernelOperator(kernel=self.kern, X=self.X), self.KT)
        self.dense = kron_reference(self.kern, self.X, self.KT)
        self.rng = rng

    def _randn(self, *shape):
        return torch.from_numpy(self.rng.standard_normal(shape).astype(np.float32))

    def test_matmul_matches_dense(self):
        M = self._randn(self.n * self.T, 5)
        np.testing.assert_allclose(self.op.matmul(M).numpy(), self.dense @ M.numpy(), **OP_TOL)
        np.testing.assert_allclose(self.op.matmul(M[:, 0]).numpy(), self.dense @ M[:, 0].numpy(),
                                   **OP_TOL)

    def test_batched_matmul(self):
        M = self._randn(2, self.n * self.T, 4)
        np.testing.assert_allclose(self.op.matmul(M).numpy(), self.dense @ M.numpy(), **OP_TOL)

    def test_diagonal_and_rows(self):
        np.testing.assert_allclose(self.op.diagonal().numpy(), np.diagonal(self.dense),
                                   rtol=1e-5, atol=1e-6)
        for i in [0, 7, self.n * self.T - 1]:
            np.testing.assert_allclose(self.op.row(i).numpy(), self.dense[i], rtol=1e-4, atol=1e-6)

    def test_per_task_noise_wrapper(self):
        noise = torch.tensor([0.1, 0.5, 1.0])
        hat = KroneckerAddedDiagOperator(self.op, noise)
        ref = kron_reference(self.kern, self.X, self.KT, noise)
        M = self._randn(self.n * self.T, 3)
        np.testing.assert_allclose(hat.matmul(M).numpy(), ref @ M.numpy(), **OP_TOL)
        np.testing.assert_allclose(hat.diagonal().numpy(), np.diagonal(ref), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(hat.row(4).numpy(), ref[4], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(hat.to_dense().numpy(), ref, rtol=1e-4, atol=1e-5)

    def test_per_task_noise_solve_matches_dense(self):
        noise = torch.tensor([0.05, 0.4, 1.5])
        hat = KroneckerAddedDiagOperator(self.op, noise)
        ref = kron_reference(self.kern, self.X, self.KT, noise)
        B = self._randn(self.n * self.T, 4)
        np.testing.assert_allclose(solve(hat, B, SET).numpy(), np.linalg.solve(ref, B.numpy()),
                                   rtol=1e-3, atol=1e-4)

    def test_precond_rank_raises_loudly(self):
        hat = KroneckerAddedDiagOperator(self.op, torch.full((3,), 0.1))
        with pytest.raises(NotImplementedError, match="task-kernel preconditioning"):
            build_preconditioner(hat, rank=5)

    def test_fused_cg_warns_and_falls_back(self):
        hat = KroneckerAddedDiagOperator(self.op, torch.full((3,), 0.1))
        with pytest.warns(UserWarning, match="no fused kernel"):
            assert hat.fused_cg_step_fn() is None
        for op in (self.op, HadamardKroneckerOperator(
                KernelOperator(kernel=self.kern, X=self.X), self.KT, torch.zeros(9, dtype=torch.long))):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                assert op.fused_cg_step_fn() is None

    def test_integer_task_ids_are_never_differentiated(self):
        """The per-task operators hold int task ids among their tensor
        leaves; they pass through the MLL's autograd Function as
        non-differentiable inputs."""
        ids = torch.tensor([0, 1, 2] * 3)
        hat = KroneckerAddedDiagOperator(
            HadamardKroneckerOperator(KernelOperator(kernel=self.kern, X=self.X), self.KT, ids),
            torch.full((3,), 0.3), ids)
        leaves = tensor_leaves(hat)
        assert sum(1 for x in leaves if x is ids) == 2
        assert not any(x.requires_grad for x in leaves if not x.is_floating_point())


class TestHadamardOperator:
    def test_gather_round_trip_on_complete_grid(self):
        rng = np.random.default_rng(1)
        n, T = 8, 3
        X = rng.uniform(0, 1, (n, 2)).astype(np.float32)
        Y = rng.standard_normal((n, T)).astype(np.float32)
        Xl, yl = to_long_format(X, Y)
        rXl, ryl = ref_to_long_format(jnp.asarray(X), jnp.asarray(Y))
        np.testing.assert_array_equal(Xl, np.asarray(rXl))
        np.testing.assert_array_equal(yl, np.asarray(ryl))
        coords, ids = split_long_format(torch.from_numpy(Xl))
        np.testing.assert_array_equal(ids.numpy(), np.tile(np.arange(T), n))
        np.testing.assert_array_equal(coords.numpy(), np.repeat(X, T, axis=0))
        kern = _kern(0.4, 1.0)
        KT = task_matrix(rng, T)
        kron = KroneckerKernelOperator(KernelOperator(kernel=kern, X=torch.from_numpy(X)), KT)
        had = HadamardKroneckerOperator(KernelOperator(kernel=kern, X=coords), KT, ids)
        np.testing.assert_allclose(had.to_dense().numpy(), kron.to_dense().numpy(),
                                   rtol=1e-4, atol=1e-5)

    def test_heterogeneous_panel_matches_dense(self):
        rng = np.random.default_rng(2)
        m, T = 17, 4
        coords = torch.from_numpy(rng.uniform(0, 1, (m, 2)).astype(np.float32))
        ids = torch.from_numpy(rng.integers(0, T, m))
        kern = _kern(0.5, 0.8)
        KT = task_matrix(rng, T)
        op = HadamardKroneckerOperator(KernelOperator(kernel=kern, X=coords), KT, ids)
        dense = (kern(coords, coords) * KT[ids][:, ids]).double().numpy()
        M = torch.from_numpy(rng.standard_normal((m, 5)).astype(np.float32))
        np.testing.assert_allclose(op.matmul(M).numpy(), dense @ M.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(op.diagonal().numpy(), np.diagonal(dense), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(op.row(5).numpy(), dense[5], rtol=1e-4, atol=1e-6)
        noise = 0.1 + 0.2 * torch.arange(T, dtype=torch.float32)
        hat = KroneckerAddedDiagOperator(op, noise, ids)
        np.testing.assert_allclose(hat.diagonal().numpy(), np.diagonal(dense) + noise[ids].numpy(),
                                   rtol=1e-5, atol=1e-6)


def _ref_pair(Xl, T, mode="cuda", ref_settings=PARITY, rank=1, **kw):
    """The reference model (dense) and the port's, with the reference's
    initial parameters carried over."""
    ref = RefMultitaskGP(num_tasks=T, task_rank=rank, settings=RefSettings(**ref_settings))
    rp = ref.init_params(jnp.asarray(Xl))
    rp["raw_noise"] = jnp.log(jnp.expm1(jnp.linspace(0.3, 0.6, T, dtype=jnp.float32)))
    gp = _gp(num_tasks=T, task_rank=rank, mode=mode,
             settings=BBMMSettings(**ref_settings), **kw)
    params = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu", model="multitask")
    return ref, rp, gp, params


class TestModeParity:
    def test_cuda_matches_dense_operator(self):
        """mode="cuda" runs the Kronecker data matmul through the kernel
        wrapper (its plain version on the CPU): the (n·T, t) right-hand side
        reaches it as one (n, T·t) block."""
        Xl, _ = grid_problem(3, n=11, T=3)
        gp_d, gp_c = _gp(num_tasks=3), _gp(num_tasks=3, mode="cuda")
        params = gp_d.init_params(Xl)
        data = gp_d.prepare_inputs(Xl)
        M = torch.from_numpy(np.random.default_rng(4).standard_normal((33, 5)).astype(np.float32))
        ref = gp_d.operator(params, data).matmul(M)
        op_c = gp_c.operator(params, data)
        np.testing.assert_allclose(op_c.matmul(M).numpy(), ref.numpy(), **OP_TOL)
        prepared = op_c.prepare()
        assert type(prepared.base.data_op).__name__ == "PreparedKernelOperator"
        np.testing.assert_allclose(prepared.matmul(M).numpy(), ref.numpy(), **OP_TOL)

    def test_mixed_precision_recurses_into_data_kernel(self):
        """with_compute_dtype reaches the data matmul (bf16 operands) while
        the task contraction and the noise stay f32 — bf16-close to the f32
        operator, and as close to the reference's mixed operator."""
        Xl, _ = grid_problem(5, n=16, T=2)
        for mode in ("dense", "cuda"):
            gp = _gp(num_tasks=2, mode=mode)
            ref, rp, _, params = _ref_pair(Xl, 2)
            data = gp.prepare_inputs(Xl)
            op = gp.operator(params, data)
            mixed = op.with_compute_dtype("mixed")
            assert mixed.base.data_op.compute_dtype == "bfloat16"
            assert mixed.task_noise is op.task_noise and mixed.base.task is op.base.task
            M = np.random.default_rng(6).standard_normal((32, 4)).astype(np.float32)
            o32 = op.matmul(torch.from_numpy(M)).numpy()
            o16 = mixed.matmul(torch.from_numpy(M)).numpy()
            rel = np.linalg.norm(o16 - o32) / np.linalg.norm(o32)
            assert 0 < rel < 0.02, rel
            ro16 = ref.operator(rp, ref.prepare_inputs(jnp.asarray(Xl))).with_compute_dtype(
                "mixed").matmul(jnp.asarray(M))
            assert np.linalg.norm(o16 - np.asarray(ro16)) / np.linalg.norm(o32) < 0.02


class TestMultitaskGPModel:
    def test_protocol_conformance_and_streaming(self):
        gp = _gp(num_tasks=3)
        assert missing_protocol_methods(gp) == []
        assert supports_streaming(gp)

    @pytest.mark.parametrize("mode", ["dense", "cuda"])
    @pytest.mark.parametrize("structure", ["auto", "hadamard"])
    def test_loss_and_gradients_match_reference(self, monkeypatch, mode, structure):
        """−MLL and its gradient into every parameter (lengthscale,
        outputscale, task root, task diagonal, per-task noise) against
        ``jax.value_and_grad`` of the reference's loss, the reference's
        probes replayed; the Kronecker path and the Hadamard path forced
        on the same grid."""
        Xl, yl = grid_problem(8, n=14, T=3)
        ref, rp, gp, params = _ref_pair(Xl, 3, mode=mode, rank=2, structure=structure)
        ref = RefMultitaskGP(num_tasks=3, task_rank=2, structure=structure,
                             settings=RefSettings(**PARITY))
        key = jax.random.PRNGKey(7)
        rdata = ref.prepare_inputs(jnp.asarray(Xl))
        rloss, rgrads = jax.value_and_grad(ref.loss)(rp, rdata, jnp.asarray(yl), key)
        queue = _replay(monkeypatch, _draws(key, 42, PARITY["num_probes"]))
        params = {k: v.requires_grad_() for k, v in params.items()}
        data = gp.prepare_inputs(Xl)
        assert (data.task_ids is None) == (structure == "auto")
        loss = gp.loss(params, data, yl, torch.Generator())
        loss.backward()
        assert not queue
        np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=MLL_RTOL)
        for name, p in params.items():
            assert float(p.grad.abs().max()) > 0, name
            assert _rel(p.grad.numpy(), rgrads[name]) <= GRAD_RTOL, name

    def test_loss_gradient_matches_cholesky_reference(self, monkeypatch):
        """The BBMM gradient averaged over 16 probe draws ≈ the dense
        Cholesky autodiff gradient, for every learned leaf — the reference
        test's panel, parameters and probe keys (PRNGKey(100 + i))."""
        kx, ky = jax.random.split(jax.random.PRNGKey(8))
        Xj = jax.random.uniform(kx, (10, 2))
        Yj = jnp.sin(3.0 * Xj[:, :1]) * (1.0 + 0.3 * jnp.arange(3)) + 0.1 * jax.random.normal(
            ky, (10, 3))
        Xl, yl = (np.asarray(a) for a in ref_to_long_format(Xj, Yj))
        settings = dict(num_probes=16, max_cg_iters=80, cg_tol=1e-7, precond_rank=0)
        ref, rp, gp, params0 = _ref_pair(Xl, 3, mode="dense", ref_settings=settings, rank=2)
        rp = ref.init_params(jnp.asarray(Xl))
        params0 = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu", model="multitask")
        data = gp.prepare_inputs(Xl)
        y = torch.from_numpy(yl).double()
        m = y.shape[0]

        params = {k: v.double().requires_grad_() for k, v in params0.items()}
        K = gp.operator(params, data._replace(X=data.X.double())).to_dense()
        L = torch.linalg.cholesky(K)
        alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
        exact = 0.5 * (y @ alpha + 2.0 * torch.log(torch.diagonal(L)).sum()
                       + m * np.log(2.0 * np.pi))
        g_exact = dict(zip(params, torch.autograd.grad(exact, list(params.values()))))
        queue = _replay(monkeypatch, [d for i in range(16)
                                      for d in _draws(jax.random.PRNGKey(100 + i), m, 16)])
        sums = {k: 0.0 for k in params0}
        for _ in range(16):
            p = {k: v.clone().requires_grad_() for k, v in params0.items()}
            gp.loss(p, data, yl, torch.Generator()).backward()
            for k in sums:
                sums[k] = sums[k] + p[k].grad.double().numpy() / 16
        assert not queue
        for name in params0:
            ge = g_exact[name].numpy()
            denom = max(float(np.abs(ge).max()), 1.0)
            assert np.abs(sums[name] - ge).max() / denom < 0.1, (name, sums[name], ge)

    def test_fit_through_shared_driver_and_against_reference(self, monkeypatch):
        """model.fit ≡ fit_gp bitwise and the loss falls; three Adam steps
        against the reference's fit with its key splits replayed."""
        Xl, yl = grid_problem(9, n=16, T=2)
        gp = _gp(num_tasks=2, settings=BBMMSettings(num_probes=4, max_cg_iters=40,
                                                    precond_rank=0))
        p1, h1 = gp.fit(Xl, yl, steps=12, lr=0.1)
        p2, h2 = fit_gp(gp, Xl, yl, steps=12, lr=0.1)
        assert h1 == h2 and np.isfinite(h1).all() and h1[-1] < h1[0]
        assert all(torch.equal(p1[k], p2[k]) for k in p1)

        ref, rp, gp, params0 = _ref_pair(Xl, 2, mode="cuda")
        rparams, rhist = ref.fit(jnp.asarray(Xl), jnp.asarray(yl), steps=3)
        key, draws = jax.random.PRNGKey(0), []
        for _ in range(3):
            key, sub = jax.random.split(key)
            draws += _draws(sub, 32, PARITY["num_probes"])
        queue = _replay(monkeypatch, draws)
        rp0 = ref.init_params(jnp.asarray(Xl))
        params0 = params_from_jax(jax.tree.map(np.asarray, rp0), device="cpu",
                                  model="multitask")
        monkeypatch.setattr(gp, "init_params", lambda X: params0)
        params, hist = gp.fit(Xl, yl, steps=3)
        assert not queue
        np.testing.assert_allclose(hist, rhist, rtol=MLL_RTOL)
        for name, v in params.items():
            assert _rel(v.numpy(), rparams[name]) <= GRAD_RTOL, name

    @pytest.mark.parametrize("mode", ["dense", "cuda"])
    def test_posterior_parity_vs_dense_reference(self, mode):
        Xl, yl = grid_problem(10, n=12, T=3)
        gp = _gp(num_tasks=3, mode=mode)
        params = gp.init_params(Xl)
        data = gp.prepare_inputs(Xl)
        kern, KT, noise = gp.kernel(params), gp.task_covariance(params), gp.noise(params)
        Khat = kron_reference(kern, data.X, KT, noise)
        rng = np.random.default_rng(11)
        coords = rng.uniform(0, 1, (7, 2)).astype(np.float32)
        qt = np.array([0, 1, 2, 0, 1, 2, 0])
        Xq = to_long_format(coords, task_ids=qt, num_tasks=3)
        Kx = kern(data.X, torch.from_numpy(coords)).double().numpy()
        KTd = KT.double().numpy()
        Kxs = (Kx[:, None, :] * KTd[:, qt][None]).reshape(Khat.shape[0], -1)
        mean_ref = Kxs.T @ np.linalg.solve(Khat, yl.astype(np.float64))
        var_ref = (float(kern.outputscale) * np.diagonal(KTd)[qt]
                   - np.sum(Kxs * np.linalg.solve(Khat, Kxs), axis=0) + noise.double().numpy()[qt])
        mean, var = gp.predict(params, data, yl, Xq)
        np.testing.assert_allclose(mean.numpy(), mean_ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(var.numpy(), var_ref, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("structure", ["auto", "hadamard"])
    def test_cached_mean_bitwise_and_variance_conservative(self, structure):
        Xl, yl = grid_problem(12, n=12, T=2)
        gp = _gp(num_tasks=2, mode="cuda", structure=structure)
        params = gp.init_params(Xl)
        data = gp.prepare_inputs(Xl)
        Xq = grid_problem(13, n=5, T=2)[0]
        cache = gp.posterior_cache(params, data, yl)
        mean_c, var_c = gp.predict_cached(params, data, cache, Xq)
        mean_p, var_p = gp.predict(params, data, yl, Xq)
        assert torch.equal(mean_c, mean_p)
        assert bool(torch.all(var_c >= var_p - 1e-5))
        _, cov = gp.predict_cached(params, data, cache, Xq, full_cov=True)
        assert cov.shape == (10, 10)

    def test_hadamard_panel_training_and_prediction(self):
        rng = np.random.default_rng(14)
        m, T = 24, 3
        coords = rng.uniform(0, 1, (m, 2)).astype(np.float32)
        ids = rng.integers(0, T, m)
        Xl = to_long_format(coords, task_ids=ids, num_tasks=T)
        yl = (np.sin(3 * coords[:, 0]) * (1 + 0.2 * ids)).astype(np.float32)
        gp = _gp(num_tasks=T, mode="cuda")
        data = gp.prepare_inputs(Xl)
        assert data.task_ids is not None
        params = {k: v.requires_grad_() for k, v in gp.init_params(Xl).items()}
        loss = gp.loss(params, data, yl, torch.Generator().manual_seed(0))
        loss.backward()
        assert np.isfinite(float(loss.detach()))
        assert all(bool(torch.isfinite(p.grad).all()) for p in params.values())
        params = {k: v.detach() for k, v in params.items()}
        kern, KT, noise = gp.kernel(params), gp.task_covariance(params), gp.noise(params)
        C = torch.from_numpy(coords).double()
        KTd, idt = KT.double(), torch.from_numpy(ids)
        Khat = kern(C, C).double() * KTd[idt][:, idt] + torch.diag(noise.double()[idt])
        mean, _ = gp.predict(params, data, yl, Xl[:5])
        Kxs = kern(C, C[:5]).double() * KTd[idt][:, idt[:5]]
        mean_ref = Kxs.T @ torch.linalg.solve(Khat, torch.from_numpy(yl).double())
        np.testing.assert_allclose(mean.numpy(), mean_ref.numpy(), rtol=1e-4, atol=1e-4)

    def test_deep_kernel_via_kernel_fn(self, monkeypatch):
        """kernel_fn plugs a DeepKernel in as K_X (dense mode): the loss and
        the gradient into the network's weight against the reference's,
        nonzero."""
        from repro.gp import DeepKernel as RefDeepKernel
        from repro.gp import RBFKernel as RefRBF

        Xl, yl = grid_problem(15, n=10, T=2)
        W0 = (0.5 * np.random.default_rng(16).standard_normal((2, 3))).astype(np.float32)

        def kernel_fn(params):
            base = RBFKernel(lengthscale=torch.exp(params["log_ell"]), outputscale=torch.tensor(1.0))
            return DeepKernel(base=base, net_params=params["net"],
                              feature_fn=lambda net, Z: torch.tanh(Z @ net["W"]))

        def ref_kernel_fn(params):
            base = RefRBF(lengthscale=jnp.exp(params["log_ell"]), outputscale=jnp.float32(1.0))
            return RefDeepKernel(base=base, net_params=params["net"],
                                 feature_fn=lambda net, Z: jnp.tanh(Z @ net["W"]))

        gp = _gp(num_tasks=2, settings=BBMMSettings(**PARITY), kernel_fn=kernel_fn,
                 extra_params_init=lambda g: {"net": {"W": torch.from_numpy(W0)},
                                              "log_ell": torch.tensor(0.0)})
        ref = RefMultitaskGP(num_tasks=2, settings=RefSettings(**PARITY), kernel_fn=ref_kernel_fn,
                             extra_params_init=lambda k: {"net": {"W": jnp.asarray(W0)},
                                                          "log_ell": jnp.float32(0.0)})
        rp = ref.init_params(jnp.asarray(Xl))
        key = jax.random.PRNGKey(0)
        rloss, rg = jax.value_and_grad(ref.loss)(rp, ref.prepare_inputs(jnp.asarray(Xl)),
                                                 jnp.asarray(yl), key)
        params = gp.init_params(Xl)
        for k in ("raw_task_root",):
            params[k] = torch.from_numpy(np.asarray(rp[k]))
        params = {k: (v.requires_grad_() if isinstance(v, torch.Tensor) else v)
                  for k, v in params.items()}
        params["net"]["W"].requires_grad_()
        queue = _replay(monkeypatch, _draws(key, 20, PARITY["num_probes"]))
        loss = gp.loss(params, gp.prepare_inputs(Xl), yl, torch.Generator())
        loss.backward()
        assert not queue
        np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=MLL_RTOL)
        gW = params["net"]["W"].grad
        assert bool(torch.isfinite(gW).all()) and float(gW.abs().max()) > 0
        assert _rel(gW.numpy(), rg["net"]["W"]) <= GRAD_RTOL
        assert _rel(params["log_ell"].grad.numpy(), rg["log_ell"]) <= GRAD_RTOL
        with pytest.raises(TypeError, match="stationary"):
            _gp(num_tasks=2, mode="cuda", kernel_fn=kernel_fn).operator(
                params, gp.prepare_inputs(Xl)).prepare()

    def test_structure_knobs(self):
        Xl, yl = grid_problem(16, n=6, T=2)
        kron = _gp(num_tasks=2, structure="kronecker")
        assert kron.prepare_inputs(Xl).task_ids is None
        forced = _gp(num_tasks=2, structure="hadamard")
        assert forced.prepare_inputs(Xl).task_ids is not None
        with pytest.raises(ValueError, match="complete data-major grid"):
            kron.prepare_inputs(Xl[:-1])
        with pytest.raises(ValueError, match="precond_rank"):
            MultitaskGP(num_tasks=2, device="cpu", settings=BBMMSettings(precond_rank=5))
        with pytest.raises(ValueError, match="task ids"):
            _gp(num_tasks=2).prepare_inputs(np.array([[0.1, 0.2, 5.0]], np.float32))
        with pytest.raises(ValueError, match="structure"):
            _gp(num_tasks=2, structure="grid")
        with pytest.raises(ValueError, match="mode must be one of"):
            _gp(num_tasks=2, mode="pallas_sharded")
        with pytest.raises(ValueError, match="mode must be one of"):
            _gp(num_tasks=2, mode="cuda_partitioned")
        sharded = _gp(num_tasks=2, mode="cuda_sharded")  # the mesh is asked for at use
        with pytest.raises(ValueError, match="needs a mesh"):
            sharded.loss(sharded.init_params(Xl), sharded.prepare_inputs(Xl), yl,
                         torch.Generator())

    def test_query_task_ids_validated(self):
        Xl, yl = grid_problem(24, n=6, T=2)
        gp = _gp(num_tasks=2)
        params = gp.init_params(Xl)
        data = gp.prepare_inputs(Xl)
        cache = gp.posterior_cache(params, data, yl)
        bad = np.array([[0.1, 0.2, 7.0]], np.float32)
        with pytest.raises(ValueError, match="query task ids"):
            gp.predict(params, data, yl, bad)
        with pytest.raises(ValueError, match="query task ids"):
            gp.predict_cached(params, data, cache, bad)

    def test_fuse_cg_loud_graceful_end_to_end(self):
        Xl, yl = grid_problem(17, n=8, T=2)
        gp, gp_f = _gp(num_tasks=2, mode="cuda"), _gp(num_tasks=2, mode="cuda", fuse_cg=True)
        params = gp.init_params(Xl)
        data = gp.prepare_inputs(Xl)
        ref = gp.loss(params, data, yl, torch.Generator().manual_seed(0))
        with pytest.warns(UserWarning, match="no fused kernel"):
            val = gp_f.loss(params, data, yl, torch.Generator().manual_seed(0))
        np.testing.assert_allclose(float(val), float(ref), rtol=1e-5)


class TestMultitaskServing:
    def test_session_observe_query_round_trip(self):
        """A complete task block keeps the grid, a single (x, task) row
        degrades the panel to Hadamard; the streamed session stays within CG
        tolerance of a fresh one, its variance conservative."""
        Xl, yl = grid_problem(18, n=12, T=2)
        gp = _gp(num_tasks=2, mode="cuda", settings=BBMMSettings(
            num_probes=4, max_cg_iters=60, cg_tol=1e-6, precond_rank=0))
        params = gp.init_params(Xl)
        session = PosteriorSession(gp, params, Xl, yl, max_staleness=8)
        v0 = session.cache_info.version
        Xq, _ = grid_problem(19, n=6, T=2)
        rng = np.random.default_rng(20)
        Xb, yb = to_long_format(rng.uniform(0, 1, (1, 2)), np.array([[0.3, -0.2]]))
        assert session.observe(Xb, yb) == "append"
        assert gp.prepare_inputs(session.X).task_ids is None
        xo = np.concatenate([rng.uniform(0, 1, (1, 2)), [[1.0]]], axis=-1)
        assert session.observe(xo, np.array([0.5])) == "append"
        assert gp.prepare_inputs(session.X).task_ids is not None
        assert session.cache_info.version == v0 + 2 and session.cache_info.staleness == 2
        mean_s, var_s = session.query(Xq)
        fresh = PosteriorSession(gp, params, session.X, session.y)
        mean_f, var_f = fresh.query(Xq)
        np.testing.assert_allclose(mean_s.numpy(), mean_f.numpy(), rtol=1e-3, atol=1e-4)
        assert bool(torch.all(var_s >= var_f - 1e-4))

    def test_rejected_observe_leaves_session_intact(self):
        Xl, yl = grid_problem(25, n=8, T=2)
        gp = _gp(num_tasks=2, settings=BBMMSettings(num_probes=4, max_cg_iters=40,
                                                    precond_rank=0))
        session = PosteriorSession(gp, gp.init_params(Xl), Xl, yl)
        n0, v0 = session.n, session.cache_info.version
        with pytest.raises(ValueError, match="task ids"):
            session.observe(np.array([[0.1, 0.2, 5.0]]), np.array([0.0]))
        assert session.n == n0 and not session.stale()
        assert session.observe(np.array([[0.3, 0.4, 1.0]]), np.array([0.2])) == "append"
        assert session.n == n0 + 1 and session.cache_info.version == v0 + 1

    def test_session_rejects_param_staleness(self):
        Xl, yl = grid_problem(22, n=8, T=2)
        gp = _gp(num_tasks=2, settings=BBMMSettings(num_probes=4, max_cg_iters=40,
                                                    precond_rank=0))
        params = gp.init_params(Xl)
        session = PosteriorSession(gp, params, Xl, yl)
        assert not session.stale()
        session.update_params({k: v + 0.05 for k, v in params.items()})
        assert session.stale()
        session.query(grid_problem(23, n=3, T=2)[0])
        assert not session.stale()

    def test_fingerprint_hashes_the_panel_geometry(self):
        """The session's fingerprint walks a MultitaskData (its coordinates,
        its task ids where the panel is heterogeneous, T)."""
        Xl, _ = grid_problem(26, n=6, T=2)
        gp = _gp(num_tasks=2)
        grid, forced = gp.prepare_inputs(Xl), _gp(num_tasks=2,
                                                  structure="hadamard").prepare_inputs(Xl)
        assert fingerprint(grid) == fingerprint(gp.prepare_inputs(Xl.copy()))
        assert fingerprint(grid) != fingerprint(forced)
        assert fingerprint(grid) != fingerprint(grid._replace(num_tasks=3))

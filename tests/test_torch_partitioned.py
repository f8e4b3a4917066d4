"""The port's partitioned million-row path against the reference's
(tests/test_partitioned.py, its single-device classes): ``mode=
"cuda_partitioned"`` / :class:`PartitionedKernelOperator` never forms K —
every matmul and every fused CG iteration streams (panel_rows × n)
row-panels — asserted through ``panel_accounting``.

Both backends run here: ``"torch"`` (plain panels under
``torch.utils.checkpoint``, held against the reference's ``"xla"``) and
``"cuda"`` (the kernel wrappers, one call per panel with its
``row_offset``; on CPU tensors they run their plain versions, so this is
the CPU side of the panel stream, the panel-fused step and the
panel-streamed VJP).  The same numpy inputs go to both packages.
Tolerances are the reference test's.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.preconditioner as port_precond
from repro.core import BBMMSettings as RefSettings
from repro.core import PartitionedKernelOperator as RefPartitioned
from repro.gp import ExactGP as RefExactGP
from repro.gp import RBFKernel as RefRBF
from repro.kernels.kernel_matmul.kernel_matmul import _FUSED_STATE_SLABS as REF_SLABS
from repro.kernels.kernel_matmul.ops import choose_panel_rows as ref_choose_panel_rows
from repro_torch import ExactGP
from repro_torch.core import (
    AddedDiagOperator,
    BBMMSettings,
    PartitionedKernelOperator,
    collect,
    engine_state,
    mbcg,
    panel_accounting,
    plain_cg_step,
)
from repro_torch.gp import KernelOperator, RBFKernel
from repro_torch.kernels.kernel_matmul import ops
from repro_torch.kernels.kernel_matmul.ops import (
    _FUSED_STATE_SLABS,
    MAX_PANEL_ROWS,
    PANEL_ALIGN,
    choose_panel_rows,
)

jax.config.update("jax_platform_name", "cpu")
pytestmark = pytest.mark.partitioned

BACKENDS = ["cuda", "torch"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _problem(n, d=4, seed=0):
    X = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    kern = RBFKernel(lengthscale=torch.tensor(0.7), outputscale=torch.tensor(1.3))
    return X, kern


def _ref_kernel():
    return RefRBF(lengthscale=jnp.float32(0.7), outputscale=jnp.float32(1.3))


class TestPanelChooser:
    def test_same_integers_as_the_reference(self):
        """The reference's formula, the reference's integers, on a grid of
        (n, budget, t, b, fused, itemsize)."""
        assert (PANEL_ALIGN, MAX_PANEL_ROWS, _FUSED_STATE_SLABS) == (128, 8192, REF_SLABS)
        for n in (1, 100, 200, 1_000, 20_000, 100_000, 200_000, 1_000_000):
            for budget in (None, 8 << 20, 512 << 20, 4 << 30):
                for t, b, fused in ((0, 1, False), (9, 1, True), (128, 4, True), (9, 4, False)):
                    for itemsize in (2, 4):
                        kw = dict(budget_bytes=budget, itemsize=itemsize, rhs_cols=t, batch=b,
                                  fused=fused)
                        assert choose_panel_rows(n, **kw) == ref_choose_panel_rows(n, **kw), kw

    def test_budget_bound_and_alignment(self):
        for n in (100, 1_000, 20_000, 100_000, 1_000_000):
            p = choose_panel_rows(n)
            assert p % PANEL_ALIGN == 0 and p <= MAX_PANEL_ROWS
            assert p == PANEL_ALIGN or p * n * 4 <= 128 * 1024 * 1024
        assert choose_panel_rows(50_000, budget_bytes=8 << 20) <= choose_panel_rows(
            50_000, budget_bytes=512 << 20)
        assert choose_panel_rows(200) <= 256
        for bad in (dict(n=0), dict(n=100, budget_bytes=0)):
            with pytest.raises(ValueError):
                choose_panel_rows(**bad)

    def test_fused_budget_accounts_cg_state(self):
        n, t, b = 50_000, 128, 4
        budget = 512 << 20
        plain = choose_panel_rows(n, budget_bytes=budget)
        fused = choose_panel_rows(n, budget_bytes=budget, rhs_cols=t, batch=b, fused=True)
        assert fused % PANEL_ALIGN == 0 and fused < plain
        per_row = n * 4 + _FUSED_STATE_SLABS * b * t * 4
        assert fused == PANEL_ALIGN or fused * per_row + 3 * n * b * t * 4 + 16 * t <= budget
        assert choose_panel_rows(n, budget_bytes=budget, rhs_cols=t, batch=b) == plain

    def test_cuda_default_fills_whole_waves(self):
        """The cuda backend's default height on the card is the tallest whole
        number of waves of B1 row blocks shorter than n (n itself when n is
        one wave or less), from the card's SM count, and binds no byte
        budget; on CPU tensors (the plain versions, which form the slab) the
        budget chooser; an explicit budget or panel_rows still wins."""
        for sms in (132, 114):
            wave = sms * ops.ROW_BLOCKS_PER_SM * ops.ROW_BLOCK
            for n in (1000, wave, wave + 1, 2 * wave, 200_000, 10**6):
                p = ops.cuda_panel_rows(n, sms)
                if n <= wave:
                    assert p == n
                else:
                    assert p % wave == 0 and wave <= p < n and n - p <= wave, (sms, n, p)
        assert ops.cuda_panel_rows(200_000, 132) == 177_408
        assert ops.cuda_panel_rows(10**6, 132) == 988_416
        X, kern = _problem(10)
        op = PartitionedKernelOperator(kernel=kern, X=_t(X), backend="cuda")
        assert op.panel_rows_for(10**6) == choose_panel_rows(10**6)
        budget = dataclasses.replace(op, panel_budget_bytes=64 << 20)
        assert budget.panel_rows_for(10**6) == choose_panel_rows(10**6, budget_bytes=64 << 20)
        assert dataclasses.replace(op, panel_rows=96).panel_rows_for(10**6) == 96


class TestPanelParity:
    """Panel vs dense (and vs the reference's xla panels) ≤ 1e-4: odd n,
    panel sizes that do not divide n, a vector and a batched RHS."""

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("n,panel_rows", [(773, 256), (257, 100)])
    def test_matmul_matches_dense(self, backend, n, panel_rows):
        X, kern = _problem(n)
        dense = KernelOperator(kernel=kern, X=_t(X), mode="dense")
        op = PartitionedKernelOperator(kernel=kern, X=_t(X), panel_rows=panel_rows,
                                       backend=backend)
        M = np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32)
        np.testing.assert_allclose(op.matmul(_t(M)).numpy(), dense.matmul(_t(M)).numpy(), **TOL)
        np.testing.assert_allclose(op.matmul(_t(M[:, 0])).numpy(),
                                   dense.matmul(_t(M[:, 0])).numpy(), **TOL)
        ref = RefPartitioned(kernel=_ref_kernel(), X=jnp.asarray(X), panel_rows=panel_rows,
                             backend="xla")
        np.testing.assert_allclose(op.matmul(_t(M)).numpy(), np.asarray(ref.matmul(jnp.asarray(M))),
                                   **TOL)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_batched_rhs(self, backend):
        n = 353
        X, kern = _problem(n)
        dense = KernelOperator(kernel=kern, X=_t(X), mode="dense")
        op = PartitionedKernelOperator(kernel=kern, X=_t(X), panel_rows=128, backend=backend)
        B = _t(np.random.default_rng(2).standard_normal((2, n, 3)).astype(np.float32))
        ref = torch.stack([dense.matmul(B[i]) for i in range(2)])
        np.testing.assert_allclose(op.matmul(B).numpy(), ref.numpy(), **TOL)

    def test_row_diagonal_exact(self):
        n = 311
        X, kern = _problem(n)
        dense = KernelOperator(kernel=kern, X=_t(X), mode="dense")
        op = PartitionedKernelOperator(kernel=kern, X=_t(X), panel_rows=64)
        np.testing.assert_allclose(op.diagonal().numpy(), dense.diagonal().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(op.row(17).numpy(), dense.row(17).numpy(), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_kernel_operator_mode_threads_through(self, backend):
        n = 300
        X, kern = _problem(n)
        ko = KernelOperator(kernel=kern, X=_t(X), mode="cuda_partitioned", panel_rows=128,
                            panel_backend=backend)
        prepared = ko.prepare()
        assert isinstance(prepared, PartitionedKernelOperator)
        assert (prepared.Xs is not None) == (backend == "cuda")
        M = _t(np.random.default_rng(1).standard_normal((n, 2)).astype(np.float32))
        ref = KernelOperator(kernel=kern, X=_t(X), mode="dense").matmul(M)
        np.testing.assert_allclose(ko.matmul(M).numpy(), ref.numpy(), **TOL)

    def test_auto_backend_follows_the_device(self):
        X, kern = _problem(50)
        assert PartitionedKernelOperator(kernel=kern, X=_t(X)).resolved_backend == "torch"
        with pytest.raises(ValueError, match="backend"):
            PartitionedKernelOperator(kernel=kern, X=_t(X), backend="xla")


class TestAccounting:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_no_full_height_panel_ever(self, backend):
        """Every recorded call streams panels strictly shorter than n — no
        n×n working set on the partitioned path."""
        n = 1031
        X, kern = _problem(n)
        op = AddedDiagOperator(
            KernelOperator(kernel=kern, X=_t(X), mode="cuda_partitioned", panel_rows=256,
                           panel_backend=backend),
            torch.tensor(0.5),
        )
        y = torch.sin(_t(X[:, 0]))
        s = BBMMSettings(num_probes=2, max_cg_iters=5, precond_rank=0, cg_tol=0.3)
        g = torch.Generator()
        g.manual_seed(0)
        with panel_accounting() as launches, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            engine_state(op, y, g, s)
        # the port records one PanelLaunch per call: one per CG iteration
        assert len(launches) == 5
        for lau in launches:
            assert lau.panel_rows < lau.n and lau.panel_bytes < lau.dense_bytes
            assert lau.num_panels == -(-lau.n // lau.panel_rows) == 5
            assert lau.backend == backend and (lau.rhs_cols, lau.batch) == (3, 1)

    def test_accounting_is_scoped(self):
        X, kern = _problem(300)
        op = PartitionedKernelOperator(kernel=kern, X=_t(X), panel_rows=128)
        M = torch.ones((300, 1))
        with panel_accounting() as launches:
            op.matmul(M)
        count = len(launches)
        op.matmul(M)  # outside the context: not recorded
        assert count == 1 and len(launches) == count


class TestGradients:
    @pytest.fixture(scope="class")
    def mll_problem(self):
        """The reference's partitioned (xla) MLL and its gradients, once
        for both backends (its first call compiles for ~8 s)."""
        n = 192
        rng = np.random.default_rng(0)
        X = rng.standard_normal((n, 4)).astype(np.float32)
        y = (np.sin(X[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
        s = dict(num_probes=4, max_cg_iters=40, precond_rank=0, panel_rows=64)
        key = jax.random.PRNGKey(2)
        Z = np.array(jax.random.rademacher(key, (n, 4), dtype=jnp.float32))
        ref_gp = RefExactGP(mode="pallas_partitioned", panel_backend="xla",
                            settings=RefSettings(**s))
        ref_params = ref_gp.init_params(X)
        rl, rg = jax.value_and_grad(ref_gp.loss)(ref_params, jnp.asarray(X), jnp.asarray(y), key)
        return X, y, s, Z, ref_params, float(rl), {k: np.asarray(v) for k, v in rg.items()}

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_mll_grad_matches_dense_and_reference(self, monkeypatch, mll_problem, backend):
        """The partitioned MLL and its gradients against the in-memory dense
        path and against the reference's partitioned (xla) path, on the
        reference's probes: MLL rtol 1e-4, gradients rtol 2e-3 / atol 1e-4."""
        X, y, s, Z, ref_params, rl, rg = mll_problem
        monkeypatch.setattr(port_precond.IdentityPreconditioner, "sample_probes",
                            lambda self, g, num, m: _t(Z).clone())
        out = {}
        for mode in ("cuda_partitioned", "dense"):
            gp = ExactGP(mode=mode, panel_backend=backend, settings=BBMMSettings(**s),
                         device="cpu")
            params = {k: _t(v).clone().requires_grad_() for k, v in ref_params.items()}
            loss = gp.loss(params, X, y, torch.Generator())
            loss.backward()
            out[mode] = (float(loss), {k: v.grad for k, v in params.items()})
        lp, gpart = out["cuda_partitioned"]
        np.testing.assert_allclose(lp, out["dense"][0], rtol=1e-4)
        np.testing.assert_allclose(lp, rl, rtol=1e-4)
        for k in gpart:
            for want in (out["dense"][1][k].numpy(), rg[k]):
                np.testing.assert_allclose(gpart[k].numpy(), want, rtol=2e-3, atol=1e-4, err_msg=k)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_custom_vjp_both_backends(self, backend):
        """The streamed matmul's gradient in ℓ (cuda: the autograd Function
        whose backward is one gradient call per panel; torch: autograd
        through checkpointed panels) equals the dense path's."""
        n = 160
        X, _ = _problem(n)
        M = _t(np.random.default_rng(1).standard_normal((n, 2)).astype(np.float32))

        def grad(make):
            ell = torch.tensor(0.7, requires_grad=True)
            kern = RBFKernel(lengthscale=ell, outputscale=torch.tensor(1.3))
            (make(kern).matmul(M) ** 2).sum().backward()
            return float(ell.grad)

        g = grad(lambda k: PartitionedKernelOperator(kernel=k, X=_t(X), panel_rows=64,
                                                     backend=backend))
        g_ref = grad(lambda k: KernelOperator(kernel=k, X=_t(X), mode="dense"))
        np.testing.assert_allclose(g, g_ref, rtol=1e-4)

    def test_panel_vjp_equals_the_symmetric_vjp(self):
        """The cuda backend's backward, one gradient call per panel over the
        panel's rows with the symmetric weight [C | M]ᵢ·[M | C]ⱼ (a panel
        that does not divide n included, a batched M folded into columns),
        against the one-launch symmetric VJP — X and the outputscale."""
        from repro_torch.kernels.kernel_matmul.kernel_matmul import (
            _fold_batch,
            kernel_matmul_grad_sym_cuda,
        )

        rng = np.random.default_rng(5)
        n = 203
        Xs = _t(rng.standard_normal((n, 3)).astype(np.float32))
        for shape in ((n, 4), (2, n, 3)):
            M = _t(rng.standard_normal(shape).astype(np.float32))
            C = _t(rng.standard_normal(shape).astype(np.float32))
            gX, gs = ops.panel_vjp_prescaled(Xs, M, C, 1.3, 64, kernel_type="matern52")
            wX, ws, _ = kernel_matmul_grad_sym_cuda(Xs, _fold_batch(M), _fold_batch(C), 1.3, 0.0,
                                                    kernel_type="matern52")
            np.testing.assert_allclose(gX.numpy(), wX.numpy(), rtol=2e-3, atol=1e-4)
            np.testing.assert_allclose(float(gs), float(ws), rtol=2e-3)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_fit_gp_trains_natively(self, backend):
        n = 128
        X = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
        y = np.sin(X @ np.ones(3, np.float32))
        s = BBMMSettings(num_probes=2, max_cg_iters=10, precond_rank=0, panel_rows=64)
        gp = ExactGP(mode="cuda_partitioned", panel_backend=backend, settings=s, device="cpu")
        params, history = gp.fit(X, y, steps=2, lr=0.05)
        assert np.isfinite(history).all() and all(bool(torch.isfinite(v).all())
                                                  for v in params.values())


class TestPanelFusedCG:
    """``fuse_cg=True`` on the partitioned path runs the panel-fused step:
    one fused call per row-panel per CG iteration, the four reductions
    folded across panels — no fallback warning, no n×n working set."""

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_engine_matches_unfused_no_fallback(self, backend):
        n = 300
        X, kern = _problem(n)
        op = AddedDiagOperator(
            KernelOperator(kernel=kern, X=_t(X), mode="cuda_partitioned", panel_rows=96,
                           panel_backend=backend),
            torch.tensor(0.5),
        )
        y = torch.sin(_t(X[:, 0]))
        s = BBMMSettings(num_probes=2, max_cg_iters=40, precond_rank=0, cg_tol=1e-6)

        def gen():
            g = torch.Generator()
            g.manual_seed(3)
            return g

        ref = engine_state(op, y, gen(), s)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # any fallback warning fails
            with panel_accounting() as launches, collect() as reports:
                st = engine_state(op, y, gen(), dataclasses.replace(s, fuse_cg=True))
        assert reports[-1].status == "CONVERGED", reports[-1].describe()
        np.testing.assert_allclose(st.solve_y.numpy(), ref.solve_y.numpy(), **TOL)
        np.testing.assert_allclose(float(st.logdet), float(ref.logdet), rtol=1e-4, atol=1e-3)
        fused = [lau for lau in launches if lau.fused]
        assert len(fused) == 40
        for lau in fused:
            assert lau.panel_rows < lau.n and lau.num_panels == -(-lau.n // lau.panel_rows)

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_tridiag_matches_unfused(self, backend):
        """The same Lanczos α/β as the unfused loop and as the reference's
        xla panel-fused step, with a last panel that does not divide (n =
        320, panel_rows = 96); over 6 iterations, where two correct f32 CG
        runs still agree (ROADMAP Queue C item 3)."""
        from repro.core import AddedDiagOperator as RefAddedDiag
        from repro.core import mbcg as ref_mbcg

        n = 320
        X, kern = _problem(n)
        op = AddedDiagOperator(
            PartitionedKernelOperator(kernel=kern, X=_t(X), panel_rows=96, backend=backend),
            torch.tensor(0.5),
        )
        step = op.fused_cg_step_fn()
        assert step is not None, "the partitioned operator must advertise a fused step"
        B = np.random.default_rng(1).standard_normal((n, 3)).astype(np.float32)
        res_f = mbcg(op.matmul, _t(B), max_iters=6, tol=0.0, fused_step=step)
        res_u = mbcg(op.matmul, _t(B), max_iters=6, tol=0.0)
        ref_op = RefAddedDiag(RefPartitioned(kernel=_ref_kernel(), X=jnp.asarray(X),
                                             panel_rows=96, backend="xla"), jnp.float32(0.5))
        res_r = ref_mbcg(ref_op.matmul, jnp.asarray(B), max_iters=6, tol=0.0,
                         fused_step=ref_op.fused_cg_step_fn())
        for other in (res_u, res_r):
            np.testing.assert_allclose(res_f.solves.numpy(), np.asarray(other.solves), **TOL)
            for key in ("tridiag_alpha", "tridiag_beta"):
                np.testing.assert_allclose(getattr(res_f, key).numpy(),
                                           np.asarray(getattr(other, key)), rtol=1e-4, atol=1e-5)

    def test_one_call_per_panel_no_dense_tile(self, monkeypatch):
        """The cuda backend's fused step calls B3's wrapper once per panel
        per iteration (the last panel at its own height), each on its
        panel's rows with the full (n, t) column state and its row offset,
        and every reduction is the fold of the panels' partials."""
        n, p, t = 300, 96, 3
        X, kern = _problem(n)
        op = AddedDiagOperator(
            PartitionedKernelOperator(kernel=kern, X=_t(X), panel_rows=p, backend="cuda"),
            torch.tensor(0.5),
        )
        calls = []
        inner = ops.fused_cg_step_cuda

        def counting(Xr, Xc, U, R, D, V, Rc, Dc, Vc, *rest, **kw):
            calls.append((Xr.shape[0], Xc.shape[0], tuple(Rc.shape), rest[5]))
            return inner(Xr, Xc, U, R, D, V, Rc, Dc, Vc, *rest, **kw)

        monkeypatch.setattr(ops, "fused_cg_step_cuda", counting)
        B = _t(np.random.default_rng(1).standard_normal((n, t)).astype(np.float32))
        z = torch.zeros(t)
        with panel_accounting() as launches:
            out = op.fused_cg_step_fn()(B, B, B, B, z, z, torch.ones(t))
        assert launches[0].num_panels == len(calls) == 4
        assert calls == [(96, n, (1, n, t), 0), (96, n, (1, n, t), 96), (96, n, (1, n, t), 192),
                         (12, n, (1, n, t), 288)]
        whole = plain_cg_step(op.matmul)(B, B, B, B, z, z, torch.ones(t))
        for a, b in zip(out[:4], whole[:4]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        for a, b in zip(out[4], whole[4]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-3)

    def test_batched_sigma2_declines_with_one_warning(self):
        n = 160
        X, kern = _problem(n)
        op = AddedDiagOperator(
            KernelOperator(kernel=kern, X=_t(X), mode="cuda_partitioned", panel_rows=64),
            torch.full((3,), 0.5),
        )
        with pytest.warns(UserWarning, match="unfused"):
            assert op.fused_cg_step_fn() is None
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert op.fused_cg_step_fn() is None  # the same operator: no re-warn
        assert not w, [str(x.message) for x in w]
        X2, kern2 = _problem(n, seed=7)
        op2 = AddedDiagOperator(
            KernelOperator(kernel=kern2, X=_t(X2), mode="cuda_partitioned", panel_rows=64),
            torch.full((3,), 0.5),
        )
        with pytest.warns(UserWarning, match="unfused"):
            assert op2.fused_cg_step_fn() is None
        part = PartitionedKernelOperator(kernel=kern, X=_t(X), panel_rows=64)
        with pytest.warns(UserWarning, match="unfused"):
            assert part.fused_cg_step_fn(sigma2=torch.full((3,), 0.5)) is None


def test_cuda_partitioned_engine_solve_and_cache_n5000(monkeypatch):
    """A real ``mode="cuda_partitioned"`` engine solve and posterior-cache
    build at n = 5,000 on the cuda backend (the kernel wrappers' plain
    versions on the CPU) with the reference's million recipe: X ~ N(0, I₄),
    y = sin(2x₀) + 0.1ε, RBF ℓ = 0.25, s = 1, σ² = 1 — converged, every
    launch a panel, α and the MLL the reference's partitioned (xla) path's
    on its probes (``TOL``; MLL rtol 1e-4), and the mean the fused path's."""
    n = 5000
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    knobs = dict(num_probes=2, max_cg_iters=10, cg_tol=0.1, precond_rank=0, panel_rows=1024)
    ref_gp = RefExactGP(mode="pallas_partitioned", panel_backend="xla",
                        settings=RefSettings(**knobs))
    ref_params = dict(ref_gp.init_params(X),
                      raw_lengthscale=jnp.float32(np.log(np.expm1(0.25))),
                      raw_noise=jnp.float32(np.log(np.expm1(1.0))))
    key = jax.random.PRNGKey(0)  # the reference cache's default key
    ref_alpha = np.asarray(ref_gp.posterior_cache(ref_params, jnp.asarray(X), jnp.asarray(y)).alpha)
    ref_mll = -float(ref_gp.loss(ref_params, jnp.asarray(X), jnp.asarray(y), key))
    Z = np.array(jax.random.rademacher(key, (n, knobs["num_probes"]), dtype=jnp.float32))
    monkeypatch.setattr(port_precond.IdentityPreconditioner, "sample_probes",
                        lambda self, g, num, m: _t(Z).clone())

    s = BBMMSettings(**knobs)
    gp = ExactGP(mode="cuda_partitioned", panel_backend="cuda", settings=s, device="cpu")
    params = {k: _t(np.array(v)) for k, v in ref_params.items()}
    with panel_accounting() as launches, collect() as reports:
        cache = gp.posterior_cache(params, X, y)
    assert launches and all(lau.panel_rows < lau.n and lau.num_panels == 5 for lau in launches)
    assert reports and reports[-1].status == "CONVERGED", reports
    assert cache.alpha.shape == (n,) and bool(torch.isfinite(cache.alpha).all())
    np.testing.assert_allclose(cache.alpha.numpy(), ref_alpha, **TOL)
    np.testing.assert_allclose(-float(gp.loss(params, X, y, torch.Generator())), ref_mll, rtol=1e-4)
    fused = ExactGP(mode="cuda_partitioned", panel_backend="cuda", fuse_cg=True, settings=s,
                    device="cpu")
    np.testing.assert_allclose(fused.posterior_cache(params, X, y).alpha.numpy(),
                               cache.alpha.numpy(), rtol=1e-3, atol=1e-3)

"""SKI's structured operators and the operator algebra: the port's Toeplitz,
Kronecker, interpolated, scaled, sum and callable operators and ``Grid``
against the reference's (counterparts of tests/test_gp_models.py:36-80,
tests/test_property.py:101-111, tests/test_precision.py:62-79 and
tests/test_inference_engine.py:134-162).

The same numpy inputs go through both packages.  Tolerances are the
reference tests': Toeplitz rtol 1e-4 / atol 1e-5, the interpolated product
and row rtol 1e-3 / atol 1e-4, the property test 2e-3; Grid taps equal and
weights within 1e-6; the interpolated diagonal 1e-5; the callable
operator's MLL gradient rtol 2e-3 / atol 1e-4 of the reference's
``jax.grad`` at the same probes (replayed into the port).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro_torch.core.preconditioner as port_precond
from repro.core import AddedDiagOperator as RefAddedDiag
from repro.core import BBMMSettings as RefSettings
from repro.core import CallableOperator as RefCallable
from repro.core import InterpolatedOperator as RefInterpolated
from repro.core import KroneckerOperator as RefKronecker
from repro.core import ToeplitzOperator as RefToeplitz
from repro.core import marginal_log_likelihood as ref_mll
from repro.gp import Grid as RefGrid
from repro_torch.core import (
    AddedDiagOperator,
    BBMMSettings,
    CallableOperator,
    DenseOperator,
    InterpolatedOperator,
    KroneckerOperator,
    LowRankRootOperator,
    ScaledOperator,
    SumOperator,
    ToeplitzOperator,
    interpolation_order,
    marginal_log_likelihood,
    tensor_leaves,
)
from repro_torch.gp import Grid

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """SKI's many small ops run fastest on one thread, and spin on many
    under a parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOEPLITZ_TOL = dict(rtol=1e-4, atol=1e-5)
INTERP_TOL = dict(rtol=1e-3, atol=1e-4)
COMMON = dict(deadline=None, max_examples=15)
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _rbf_column(m, scale):
    return np.exp(-0.5 * (np.arange(m) * scale) ** 2).astype(np.float32)


def _dense_W(idx, val, m):
    W = np.zeros((idx.shape[0], m), np.float64)
    for r in range(idx.shape[0]):
        np.add.at(W[r], idx[r], val[r])
    return W


def _interp_pair(d, n, size, seed):
    """The same points and grid kernel in both packages: (port op, reference
    op, dense float64 W·K·Wᵀ)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d)).astype(np.float32)
    grid, rgrid = Grid.fit(_t(X), (size,) * d), RefGrid.fit(jnp.asarray(X), (size,) * d)
    idx, val = grid.interpolate(_t(X))
    ridx, rval = rgrid.interpolate(jnp.asarray(X))
    cols = [np.exp(-0.5 * ((_np(grid.points(k)) - _np(grid.points(k))[0]) / 0.3) ** 2)
            .astype(np.float32) for k in range(d)]
    if d == 1:
        base, rbase = ToeplitzOperator(_t(cols[0])), RefToeplitz(jnp.asarray(cols[0]))
    else:
        base = KroneckerOperator(tuple(ToeplitzOperator(_t(c)) for c in cols))
        rbase = RefKronecker(tuple(RefToeplitz(jnp.asarray(c)) for c in cols))
    op = InterpolatedOperator(indices=idx, values=val, base=base)
    rop = RefInterpolated(indices=ridx, values=rval, base=rbase)
    W = _dense_W(_np(idx), _np(val).astype(np.float64), size ** d)
    return op, rop, W @ _np(base.to_dense()).astype(np.float64) @ W.T


class TestToeplitzAndKronecker:
    def test_toeplitz_matmul_and_row_match_dense_and_reference(self):
        col = _rbf_column(32, 0.13)
        M = np.random.default_rng(0).standard_normal((32, 5)).astype(np.float32)
        op, rop = ToeplitzOperator(_t(col)), RefToeplitz(jnp.asarray(col))
        out = _np(op.matmul(_t(M)))
        np.testing.assert_allclose(out, _np(op.to_dense()) @ M, **TOEPLITZ_TOL)
        np.testing.assert_allclose(out, np.asarray(rop.matmul(jnp.asarray(M))), **TOEPLITZ_TOL)
        np.testing.assert_array_equal(_np(op.to_dense()), np.asarray(rop.to_dense()))
        col = np.linspace(1.0, 0.1, 16, dtype=np.float32)
        op = ToeplitzOperator(_t(col))
        np.testing.assert_allclose(_np(op.row(5)), _np(op.to_dense())[5], atol=1e-6)
        np.testing.assert_array_equal(_np(op.row(torch.tensor(5))), np.asarray(RefToeplitz(
            jnp.asarray(col)).row(5)))
        np.testing.assert_array_equal(_np(op.diagonal()), np.full(16, col[0]))
        # a vector in, a vector out
        v = M[:32, 0]
        np.testing.assert_allclose(_np(ToeplitzOperator(_t(_rbf_column(32, 0.13))).matmul(_t(v))),
                                   out[:, 0], rtol=1e-6, atol=1e-7)

    def test_kronecker_matmul_diagonal_row_match_dense_and_reference(self):
        A, B = _rbf_column(6, 0.3), _rbf_column(4, 0.5)
        kron = KroneckerOperator((ToeplitzOperator(_t(A)), ToeplitzOperator(_t(B))))
        rkron = RefKronecker((RefToeplitz(jnp.asarray(A)), RefToeplitz(jnp.asarray(B))))
        dense = np.kron(_np(kron.factors[0].to_dense()), _np(kron.factors[1].to_dense()))
        M = np.random.default_rng(1).standard_normal((24, 3)).astype(np.float32)
        out = _np(kron.matmul(_t(M)))
        np.testing.assert_allclose(out, dense @ M, **TOEPLITZ_TOL)
        np.testing.assert_allclose(out, np.asarray(rkron.matmul(jnp.asarray(M))), **TOEPLITZ_TOL)
        np.testing.assert_allclose(_np(kron.diagonal()), np.diagonal(dense), rtol=1e-5)
        for i in [0, 7, 23]:
            np.testing.assert_allclose(_np(kron.row(i)), dense[i], rtol=1e-4, atol=1e-6)
            np.testing.assert_array_equal(_np(kron.row(torch.tensor(i))), np.asarray(rkron.row(i)))
        a, b = torch.tensor([[0, 7], [23, 5]]), torch.tensor([[3, 7], [0, 22]])
        np.testing.assert_allclose(_np(kron.entries(a, b)), dense[_np(a), _np(b)], rtol=1e-6)

    @settings(**COMMON)
    @given(st.integers(0, 10_000), st.integers(4, 64))
    def test_toeplitz_fft_matmul_property(self, seed, m):
        """FFT circulant-embedding matmul ≡ dense Toeplitz matmul, any size."""
        rng = np.random.default_rng(seed)
        col = rng.uniform(-1, 1, m).astype(np.float32)
        col[0] = abs(col[0]) + 1.0
        M = rng.standard_normal((m, 3)).astype(np.float32)
        op = ToeplitzOperator(_t(col))
        np.testing.assert_allclose(_np(op.matmul(_t(M))), _np(op.to_dense()) @ M,
                                   rtol=2e-3, atol=2e-3)


class TestGridAndInterpolation:
    @pytest.mark.parametrize("d,size", [(1, 24), (2, 12), (3, 8)])
    def test_grid_taps_equal_and_weights_close(self, d, size):
        rng = np.random.default_rng(d)
        X = rng.uniform(-1, 1, (60, d)).astype(np.float32)
        Q = rng.uniform(-1.3, 1.3, (25, d)).astype(np.float32)  # some beyond the grid
        grid, rgrid = Grid.fit(_t(X), (size,) * d), RefGrid.fit(jnp.asarray(X), (size,) * d)
        np.testing.assert_array_equal(_np(grid.mins), np.asarray(rgrid.mins))
        np.testing.assert_array_equal(_np(grid.steps), np.asarray(rgrid.steps))
        for k in range(d):
            np.testing.assert_array_equal(_np(grid.points(k)), np.asarray(rgrid.points(k)))
        for pts in (X, Q):
            idx, val = grid.interpolate(_t(pts))
            ridx, rval = rgrid.interpolate(jnp.asarray(pts))
            assert idx.dtype == torch.int64 and idx.shape == (pts.shape[0], 4 ** d)
            np.testing.assert_array_equal(_np(idx), np.asarray(ridx))
            np.testing.assert_allclose(_np(val), np.asarray(rval), rtol=0, atol=1e-6)
            # a point's taps are distinct (what _cross's direct write needs)
            assert all(len(set(r)) == 4 ** d for r in _np(idx).tolist())
        # the cubic weights of an interior point sum to 1
        np.testing.assert_allclose(_np(grid.interpolate(_t(X))[1]).sum(1), 1.0, atol=1e-5)

    def test_interpolation_order_is_a_csr_of_w_transpose(self):
        idx = torch.tensor([[2, 3], [0, 2], [3, 3], [1, 0]])
        order, offsets = interpolation_order(idx, 5)
        assert order.tolist() == [2, 7, 6, 0, 3, 1, 4, 5]  # stable: row order within a point
        assert offsets.tolist() == [0, 2, 3, 5, 8, 8]  # grid point 4 holds nothing

    @pytest.mark.parametrize("d,n,size", [(1, 40, 24), (2, 30, 8)])
    def test_interpolated_matmul_row_match_dense_and_reference(self, d, n, size):
        op, rop, dense = _interp_pair(d, n, size, seed=4)
        M = np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32)
        out = _np(op.matmul(_t(M)))
        np.testing.assert_allclose(out, dense @ M, **INTERP_TOL)
        np.testing.assert_allclose(out, np.asarray(rop.matmul(jnp.asarray(M))), **INTERP_TOL)
        for i in (0, 11):
            row = _np(op.row(torch.tensor(i)))
            np.testing.assert_allclose(row, dense[i], **INTERP_TOL)
            np.testing.assert_allclose(row, np.asarray(rop.row(i)), **INTERP_TOL)
        np.testing.assert_allclose(_np(op.prepare().matmul(_t(M))), out, rtol=0, atol=0)

    @pytest.mark.parametrize("d,n,size", [(1, 40, 24), (2, 30, 8)])
    def test_interpolated_diagonal_from_entries(self, d, n, size):
        """Entries read directly (|a − b| for Toeplitz, factor products for
        Kronecker) give the reference's row-built diagonal and the dense one;
        a base with only rows (a dense matrix) takes the row fallback."""
        op, rop, dense = _interp_pair(d, n, size, seed=6)
        diag = _np(op.diagonal())
        np.testing.assert_allclose(diag, np.asarray(rop.diagonal()), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(diag, np.diagonal(dense), rtol=1e-5, atol=1e-5)
        fallback = dataclasses.replace(op, base=DenseOperator(op.base.to_dense()))
        np.testing.assert_allclose(_np(fallback.diagonal()), diag, rtol=1e-6, atol=1e-7)

    def test_w_and_w_transpose_are_each_others_backward(self):
        """W·V and Wᵀ·M against the dense W, forward and every gradient
        (V, M and the weights), and two evaluations bit for bit."""
        op, _, _ = _interp_pair(2, 30, 8, seed=7)
        rng = np.random.default_rng(8)
        W = torch.from_numpy(_dense_W(_np(op.indices), _np(op.values).astype(np.float64), 64))
        V = torch.from_numpy(rng.standard_normal((64, 3))).requires_grad_()
        M = torch.from_numpy(rng.standard_normal((30, 3))).requires_grad_()
        values = op.values.double().requires_grad_()
        op64 = dataclasses.replace(op, values=values)
        G1 = torch.from_numpy(rng.standard_normal((30, 3)))
        G2 = torch.from_numpy(rng.standard_normal((64, 3)))
        out1, out2 = op64._W_matmul(V), op64._Wt_matmul(M)
        torch.testing.assert_close(out1, W @ V, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(out2, W.T @ M, rtol=1e-12, atol=1e-12)
        gV, gv1 = torch.autograd.grad(out1, [V, values], G1)
        gM, gv2 = torch.autograd.grad(out2, [M, values], G2)
        torch.testing.assert_close(gV, W.T @ G1, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(gM, W @ G2, rtol=1e-12, atol=1e-12)
        idx = op.indices
        dW1 = G1 @ V.detach().T  # ∂/∂W of ⟨G1, W V⟩, read at the nonzeros
        dW2 = M.detach() @ G2.T
        rows = torch.arange(30)[:, None]
        torch.testing.assert_close(gv1, dW1[rows, idx], rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(gv2, dW2[rows, idx], rtol=1e-12, atol=1e-12)
        # double backward reaches through the pair
        g, = torch.autograd.grad(op64._W_matmul(V), V, G1, create_graph=True)
        assert g.requires_grad
        assert torch.equal(op64._Wt_matmul(M), out2) and torch.equal(op64._W_matmul(V), out1)


class TestAlgebraAndPrecision:
    def _dense_ops(self):
        rng = np.random.default_rng(9)
        A = rng.standard_normal((12, 12)).astype(np.float32)
        K = A @ A.T + np.eye(12, dtype=np.float32)
        R = rng.standard_normal((12, 3)).astype(np.float32)
        return K, R

    def test_scaled_and_sum_match_dense(self):
        K, R = self._dense_ops()
        op = 2.0 * DenseOperator(_t(K)) + LowRankRootOperator(_t(R))
        assert isinstance(op, SumOperator) and isinstance(op.ops[0], ScaledOperator)
        assert op.ops[0].scale.dtype == torch.float32
        dense = 2.0 * K + R @ R.T
        M = np.random.default_rng(10).standard_normal((12, 4)).astype(np.float32)
        np.testing.assert_allclose(_np(op.matmul(_t(M))), dense @ M, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_np(op.diagonal()), np.diagonal(dense), rtol=1e-5)
        np.testing.assert_allclose(_np(op.row(3)), dense[3], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(op.to_dense()), dense, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(_np((DenseOperator(_t(K)) * 0.5).matmul(_t(M))),
                                   0.5 * K @ M, rtol=1e-5, atol=1e-5)
        with pytest.raises(TypeError):
            DenseOperator(_t(K)) + 1.0
        prepared = op.prepare()
        assert isinstance(prepared, SumOperator) and isinstance(prepared.ops[0], ScaledOperator)

    def test_with_compute_dtype_recursion(self):
        """Wrappers recurse; σ² and scales stay f32; Toeplitz (the FFT
        product) is the documented no-op."""
        K, _ = self._dense_ops()
        op = AddedDiagOperator(
            SumOperator((ScaledOperator(DenseOperator(_t(K)), torch.tensor(2.0)),
                         LowRankRootOperator(_t(K[:, :3])))),
            torch.tensor(0.1),
        )
        mixed = op.with_compute_dtype("mixed")
        assert mixed.base.ops[0].base.compute_dtype == "bfloat16"
        assert mixed.base.ops[1].compute_dtype == "bfloat16"
        assert mixed.base.ops[0].scale.dtype == torch.float32
        assert float(mixed.sigma2) == float(op.sigma2)
        toe = ToeplitzOperator(torch.arange(4.0))
        assert toe.with_compute_dtype("mixed") is toe
        kron = KroneckerOperator((toe, toe)).with_compute_dtype("mixed")
        assert isinstance(kron, KroneckerOperator) and kron.factors[0] is toe
        interp = InterpolatedOperator(torch.zeros((3, 4), dtype=torch.int64), torch.ones(3, 4),
                                      DenseOperator(_t(K))).with_compute_dtype("mixed")
        assert interp.base.compute_dtype == "bfloat16" and interp.values.dtype == torch.float32
        with pytest.raises(ValueError):
            toe.with_compute_dtype("float16")


def _callable_problem():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((50, 4)).astype(np.float32)
    y = (X @ np.array([1.0, -2.0, 0.5, 0.0], np.float32)
         + 0.05 * rng.standard_normal(50)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def reference_callable_grad():
    """The reference's MLL and its jax.grad for the 'BLR in three lines'
    CallableOperator (tests/test_inference_engine.py:134-162), and the
    Rademacher draws its engine took."""
    X, y = _callable_problem()
    Xj = jnp.asarray(X)
    s = RefSettings(precond_rank=0, max_cg_iters=50, num_probes=16)

    def mll(params, k):
        op = RefCallable(
            params=params,
            matmul_fn=lambda p, M: (Xj * p["scales"]) @ ((Xj * p["scales"]).T @ M) + p["noise"] * M,
            diag_fn=lambda p: jnp.sum((Xj * p["scales"]) ** 2, 1) + p["noise"],
            n=50,
        )
        return ref_mll(op, jnp.asarray(y), k, s)

    params = {"scales": jnp.ones((4,)), "noise": jnp.float32(0.1)}
    key = jax.random.PRNGKey(10)
    value, grads = jax.value_and_grad(mll)(params, key)
    draws = np.array(jax.random.rademacher(key, (50, 16), dtype=jnp.float32))
    return float(value), {k: np.asarray(v) for k, v in grads.items()}, draws


def test_callable_operator_gradient_matches_reference(monkeypatch, reference_callable_grad):
    value, rgrads, draws = reference_callable_grad
    X, y = _callable_problem()
    Xt = _t(X)
    monkeypatch.setattr(port_precond, "_rademacher",
                        lambda generator, shape, dtype, device: _t(draws).to(dtype))
    params = {"scales": torch.ones(4, requires_grad=True),
              "noise": torch.tensor(0.1, requires_grad=True)}
    op = CallableOperator(
        params=params,
        matmul_fn=lambda p, M: (Xt * p["scales"]) @ ((Xt * p["scales"]).T @ M) + p["noise"] * M,
        diag_fn=lambda p: torch.sum((Xt * p["scales"]) ** 2, 1) + p["noise"],
        n=50,
    )
    assert tensor_leaves(op) == [params["scales"], params["noise"]]
    assert op.shape == (50, 50) and op.device == torch.device("cpu")
    mll = marginal_log_likelihood(op, _t(y), torch.Generator(),
                                  BBMMSettings(precond_rank=0, max_cg_iters=50, num_probes=16))
    mll.backward()
    np.testing.assert_allclose(float(mll.detach()), value, rtol=1e-4)
    for name in ("scales", "noise"):
        np.testing.assert_allclose(_np(params[name].grad), rgrads[name], **GRAD_TOL)
    assert abs(float(params["noise"].grad)) > 0.0
    # the defaults through matmul: a row and the diagonal without callbacks
    plain = CallableOperator(params=params, matmul_fn=op.matmul_fn, n=50)
    with torch.no_grad():
        np.testing.assert_allclose(_np(plain.diagonal()), _np(op.diagonal()), rtol=1e-5)
        np.testing.assert_allclose(_np(plain.row(3)), _np(op.to_dense()[3]), rtol=1e-5, atol=1e-5)


def test_interpolated_operator_mll_matches_reference(monkeypatch):
    """The MLL of W·K·Wᵀ + σ²I through the engine (rank 0, 5 CG iterations)
    against the reference's at the same probes: rtol 1e-4."""
    op, rop, _ = _interp_pair(1, 60, 24, seed=12)
    y = np.sin(3 * np.linspace(0, 1, 60)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    rs = RefSettings(precond_rank=0, max_cg_iters=5, num_probes=4)
    rval = float(ref_mll(RefAddedDiag(rop, jnp.float32(0.2)), jnp.asarray(y), key, rs))
    draws = np.array(jax.random.rademacher(key, (60, 4), dtype=jnp.float32))
    monkeypatch.setattr(port_precond, "_rademacher",
                        lambda generator, shape, dtype, device: _t(draws).to(dtype))
    val = marginal_log_likelihood(AddedDiagOperator(op, torch.tensor(0.2)), _t(y),
                                  torch.Generator(),
                                  BBMMSettings(precond_rank=0, max_cg_iters=5, num_probes=4))
    np.testing.assert_allclose(float(val), rval, rtol=1e-4)

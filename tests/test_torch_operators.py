"""The port's kernels, operators, pivoted Cholesky and preconditioner
against the reference's, on the same numpy inputs.

Kernel-operator products use the kernel tolerance (2e-4,
tests/test_kernel_matmul_pallas.py:23); the pivoted-Cholesky factor and
the preconditioner's solve / logdet / inv_quad rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    AddedDiagOperator as RefAddedDiag,
    DenseOperator as RefDense,
    DiagOperator as RefDiag,
    build_preconditioner as ref_build_preconditioner,
    pivoted_cholesky_dense as ref_pivoted_cholesky_dense,
)
from repro.gp import (
    CrossKernelOperator as RefCross,
    KernelOperator as RefKernelOperator,
    MaternKernel as RefMatern,
    RBFKernel as RefRBF,
    sq_dist as ref_sq_dist,
)
from repro_torch.core import (
    AddedDiagOperator,
    DenseOperator,
    DiagOperator,
    IdentityPreconditioner,
    PivotedCholeskyPreconditioner,
    build_preconditioner,
    pivoted_cholesky,
    pivoted_cholesky_dense,
)
from repro_torch.gp import (
    CrossKernelOperator,
    KernelOperator,
    MaternKernel,
    PreparedKernelOperator,
    RBFKernel,
    sq_dist,
)

KTOL = dict(rtol=2e-4, atol=2e-4)
PTOL = dict(rtol=1e-4, atol=1e-5)
NUS = {"rbf": None, "matern12": 0.5, "matern32": 1.5, "matern52": 2.5}


def _data(seed, n=83, d=3, t=5, ard=True):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    M = rng.standard_normal((n, t)).astype(np.float32)
    ell = rng.uniform(0.3, 0.9, d).astype(np.float32) if ard else np.float32(0.5)
    return X, M, ell


def _kernels(kernel_type, ell, s=1.3):
    nu = NUS[kernel_type]
    ell_t, s_t = torch.as_tensor(ell), torch.tensor(s, dtype=torch.float32)
    ell_j, s_j = jnp.asarray(ell), jnp.float32(s)
    if nu is None:
        return RBFKernel(ell_t, s_t), RefRBF(lengthscale=ell_j, outputscale=s_j)
    return MaternKernel(ell_t, s_t, nu), RefMatern(lengthscale=ell_j, outputscale=s_j, nu=nu)


def test_sq_dist_matches_reference():
    X, _, _ = _data(0)
    Y = X[:40] + 0.1
    np.testing.assert_allclose(
        sq_dist(torch.from_numpy(X), torch.from_numpy(Y)).numpy(),
        np.asarray(ref_sq_dist(jnp.asarray(X), jnp.asarray(Y))),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("kernel_type", list(NUS))
def test_kernel_values_and_diagonal(kernel_type):
    X, _, ell = _data(1)
    Y = X[::3] * 0.9
    k, kr = _kernels(kernel_type, ell)
    Xt, Yt = torch.from_numpy(X), torch.from_numpy(Y)
    np.testing.assert_allclose(
        k(Xt, Yt).numpy(), np.asarray(kr(jnp.asarray(X), jnp.asarray(Y))), **KTOL
    )
    np.testing.assert_allclose(k.diag(Xt).numpy(), np.asarray(kr.diag(jnp.asarray(X))))


@pytest.mark.parametrize("kernel_type", ["rbf", "matern32", "matern52"])
@pytest.mark.parametrize("mode", ["dense", "blocked", "cuda"])
def test_kernel_operator_modes_match_reference(kernel_type, mode):
    """Every port mode against the reference's dense and pallas modes."""
    X, M, ell = _data(2)
    k, kr = _kernels(kernel_type, ell)
    op = KernelOperator(kernel=k, X=torch.from_numpy(X), mode=mode, block_size=32)
    out = op.matmul(torch.from_numpy(M)).numpy()
    for ref_mode in ("dense", "pallas"):
        ref = RefKernelOperator(kernel=kr, X=jnp.asarray(X), mode=ref_mode)
        np.testing.assert_allclose(out, np.asarray(ref.matmul(jnp.asarray(M))), **KTOL)
    # vector right-hand side keeps its shape
    vec = op.matmul(torch.from_numpy(M[:, 0]))
    assert vec.shape == (X.shape[0],)
    np.testing.assert_allclose(vec.numpy(), out[:, 0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["dense", "blocked", "cuda"])
def test_row_and_diagonal_accessors(mode):
    X, _, ell = _data(3)
    k, kr = _kernels("matern52", ell)
    op = KernelOperator(kernel=k, X=torch.from_numpy(X), mode=mode)
    ref = RefKernelOperator(kernel=kr, X=jnp.asarray(X), mode="dense")
    for i in (0, 7, X.shape[0] - 1):
        np.testing.assert_allclose(op.row(i).numpy(), np.asarray(ref.row(i)), **KTOL)
    np.testing.assert_allclose(op.diagonal().numpy(), np.asarray(ref.diagonal()))


def test_prepare_hoists_prescaling():
    """cuda-mode prepare() pre-scales X once; the prepared matmul equals the
    unprepared one and the reference's prepared pallas operator (ARD)."""
    X, M, ell = _data(4)
    k, kr = _kernels("rbf", ell)
    op = KernelOperator(kernel=k, X=torch.from_numpy(X), mode="cuda")
    prepared = op.prepare()
    assert isinstance(prepared, PreparedKernelOperator)
    np.testing.assert_allclose(
        prepared.Xs.numpy(), X / ell, rtol=1e-6
    )
    Mt = torch.from_numpy(M)
    np.testing.assert_allclose(prepared.matmul(Mt).numpy(), op.matmul(Mt).numpy(), rtol=1e-6, atol=1e-6)
    ref = RefKernelOperator(kernel=kr, X=jnp.asarray(X), mode="pallas").prepare()
    np.testing.assert_allclose(
        prepared.matmul(Mt).numpy(), np.asarray(ref.matmul(jnp.asarray(M))), **KTOL
    )
    np.testing.assert_allclose(prepared.row(5).numpy(), op.row(5).numpy())
    np.testing.assert_allclose(prepared.diagonal().numpy(), op.diagonal().numpy())
    # dense / blocked have nothing to hoist
    dense = KernelOperator(kernel=k, X=torch.from_numpy(X), mode="dense")
    assert dense.prepare() is dense


def test_cross_kernel_operator():
    X, M, ell = _data(5)
    Y = X[:20] * 0.7
    k, kr = _kernels("matern52", ell)
    cross = CrossKernelOperator(k, torch.from_numpy(X), torch.from_numpy(Y))
    ref = RefCross(kr, jnp.asarray(X), jnp.asarray(Y))
    assert cross.shape == ref.shape
    np.testing.assert_allclose(cross.to_dense().numpy(), np.asarray(ref.to_dense()), **KTOL)
    W = M[:20]
    np.testing.assert_allclose(
        cross.matmul(torch.from_numpy(W)).numpy(), np.asarray(ref.matmul(jnp.asarray(W))), **KTOL
    )
    np.testing.assert_allclose(
        cross.rmatmul(torch.from_numpy(M)).numpy(), np.asarray(ref.rmatmul(jnp.asarray(M))), **KTOL
    )


def test_dense_diag_and_added_diag_operators():
    rng = np.random.default_rng(6)
    A = rng.standard_normal((30, 30)).astype(np.float32)
    A = A @ A.T
    dvec = rng.uniform(0.5, 2.0, 30).astype(np.float32)
    M = rng.standard_normal((30, 4)).astype(np.float32)
    pairs = [
        (DenseOperator(torch.from_numpy(A)), RefDense(jnp.asarray(A))),
        (DiagOperator(torch.from_numpy(dvec)), RefDiag(jnp.asarray(dvec))),
        (
            AddedDiagOperator(DenseOperator(torch.from_numpy(A)), torch.tensor(0.3)),
            RefAddedDiag(RefDense(jnp.asarray(A)), jnp.float32(0.3)),
        ),
    ]
    for op, ref in pairs:
        assert op.shape == ref.shape
        np.testing.assert_allclose(
            op.matmul(torch.from_numpy(M)).numpy(), np.asarray(ref.matmul(jnp.asarray(M))),
            rtol=1e-5, atol=1e-4,
        )
        np.testing.assert_allclose(op.diagonal().numpy(), np.asarray(ref.diagonal()), rtol=1e-6)
        np.testing.assert_allclose(op.row(3).numpy(), np.asarray(ref.row(3)), rtol=1e-6)
        np.testing.assert_allclose(op.to_dense().numpy(), np.asarray(ref.to_dense()), rtol=1e-6)
    assert pairs[2][0].prepare().base is pairs[2][0].base  # dense: prepare is a no-op


def test_unported_modes_and_precision_raise():
    X, _, ell = _data(7)
    k, _ = _kernels("rbf", ell)
    with pytest.raises(NotImplementedError, match="step 16"):
        KernelOperator(kernel=k, X=torch.from_numpy(X), mode="pallas_sharded")
    # the port renames the reference's pallas modes: pallas → cuda,
    # pallas_partitioned → cuda_partitioned
    for mode in ("pallas", "pallas_partitioned"):
        with pytest.raises(ValueError, match="mode must be one of"):
            KernelOperator(kernel=k, X=torch.from_numpy(X), mode=mode)
    assert KernelOperator(kernel=k, X=torch.from_numpy(X), mode="cuda_partitioned").shape == (
        X.shape[0], X.shape[0])
    op = KernelOperator(kernel=k, X=torch.from_numpy(X), mode="cuda")
    # the precision policy is ported: "mixed" selects bf16 operands, and an
    # unknown dtype is refused
    assert op.with_compute_dtype("mixed").compute_dtype == "bfloat16"
    assert op.with_compute_dtype("highest").compute_dtype == "float32"
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        op.with_compute_dtype("float16")


@pytest.mark.parametrize("kernel_type", ["rbf", "matern52"])
def test_pivoted_cholesky_matches_reference(kernel_type):
    X, _, ell = _data(8, n=120)
    k, kr = _kernels(kernel_type, ell)
    K = k(torch.from_numpy(X), torch.from_numpy(X))
    Kr = kr(jnp.asarray(X), jnp.asarray(X))
    L_ref = np.asarray(ref_pivoted_cholesky_dense(Kr, 6))
    np.testing.assert_allclose(pivoted_cholesky_dense(K, 6).numpy(), L_ref, **PTOL)
    # the row/diagonal form the engine uses
    op = KernelOperator(kernel=k, X=torch.from_numpy(X), mode="cuda")
    L = pivoted_cholesky(op.row, op.diagonal(), 6)
    np.testing.assert_allclose(L.numpy(), L_ref, **PTOL)


def test_pivoted_cholesky_stops_at_numerical_rank():
    rng = np.random.default_rng(9)
    R = rng.standard_normal((40, 3)).astype(np.float32)
    K = torch.from_numpy(R @ R.T)
    L = pivoted_cholesky_dense(K, 6, jitter=1e-4)
    assert torch.all(L[:, 3:] == 0)
    np.testing.assert_allclose((L @ L.T).numpy(), K.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("rank", [0, 5])
def test_preconditioner_matches_reference(rank):
    X, M, ell = _data(10, n=150)
    k, kr = _kernels("matern52", ell)
    op = AddedDiagOperator(KernelOperator(kernel=k, X=torch.from_numpy(X), mode="cuda"), torch.tensor(0.1))
    ref_op = RefAddedDiag(RefKernelOperator(kernel=kr, X=jnp.asarray(X), mode="dense"), jnp.float32(0.1))
    P = build_preconditioner(op, rank)
    Pr = ref_build_preconditioner(ref_op, rank)
    Z = np.array(Pr.sample_probes(jax.random.PRNGKey(0), 4, X.shape[0]))
    Mt = torch.from_numpy(M)
    np.testing.assert_allclose(P.solve(Mt).numpy(), np.asarray(Pr.solve(jnp.asarray(M))), **PTOL)
    np.testing.assert_allclose(
        P.solve(Mt[:, 0]).numpy(), np.asarray(Pr.solve(jnp.asarray(M[:, 0]))), **PTOL
    )
    np.testing.assert_allclose(float(P.logdet()), float(Pr.logdet()), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        P.inv_quad(torch.from_numpy(Z)).numpy(), np.asarray(Pr.inv_quad(jnp.asarray(Z))), **PTOL
    )
    if rank:
        assert isinstance(P, PivotedCholeskyPreconditioner)
        np.testing.assert_allclose(P.L.numpy(), np.asarray(Pr.L), **PTOL)
        np.testing.assert_allclose(
            P.matmul(Mt).numpy(), np.asarray(Pr.matmul(jnp.asarray(M))), rtol=1e-4, atol=1e-4
        )
    else:
        assert isinstance(P, IdentityPreconditioner)


def test_sample_probes_are_seeded_rademacher_with_covariance_p():
    """z = L g₁ + σ g₂: seeded draws repeat, and E[zzᵀ] = P̂."""
    rng = np.random.default_rng(11)
    L = torch.from_numpy(rng.standard_normal((12, 2)).astype(np.float32))
    P = PivotedCholeskyPreconditioner.build(L, 0.25)
    draw = lambda: P.sample_probes(torch.Generator().manual_seed(3), 40_000, 12)  # noqa: E731
    Z = draw()
    assert Z.shape == (12, 40_000) and torch.equal(Z, draw())
    cov = (Z @ Z.T / Z.shape[1]).numpy()
    target = P.matmul(torch.eye(12)).numpy()
    np.testing.assert_allclose(cov, target, atol=0.1 * np.abs(target).max())
    Zi = IdentityPreconditioner().sample_probes(torch.Generator().manual_seed(0), 5, 9)
    assert set(torch.unique(Zi).tolist()) == {-1.0, 1.0}


def test_preconditioner_requires_added_diag():
    X, _, ell = _data(12)
    k, _ = _kernels("rbf", ell)
    with pytest.raises(TypeError, match="AddedDiagOperator"):
        build_preconditioner(KernelOperator(kernel=k, X=torch.from_numpy(X)), 3)

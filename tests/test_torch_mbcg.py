"""The port's mBCG, tridiagonal recovery and SLQ against the reference's,
field by field, on a fixed SPD matrix with one shared right-hand side block.

Tolerances: solves rtol 1e-4; tridiagonal α/β rtol 1e-3; ``num_iters`` and
``active_steps`` equal; ``residual_norm`` rtol 1e-3; SLQ log-det rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    logdet_from_mbcg as ref_logdet_from_mbcg,
    mbcg as ref_mbcg,
    tridiag_matrices as ref_tridiag_matrices,
)
from repro.core.preconditioner import PivotedCholeskyPreconditioner as RefPrecond
from repro_torch.core import (
    PivotedCholeskyPreconditioner,
    logdet_from_mbcg,
    mbcg,
    pivoted_cholesky_dense,
    tridiag_matrices,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spd(seed, n, cond):
    """A fixed SPD matrix with a log-spaced spectrum of condition ``cond``."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, np.log10(cond), n)
    return ((Q * eigs) @ Q.T).astype(np.float32), rng


def _run_both(A, B, *, precond_rank=0, sigma2=0.5, **kw):
    At, Bt = torch.from_numpy(A), torch.from_numpy(B)
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    p_solve = r_solve = None
    if precond_rank:
        # the same factor on both sides, so the comparison is of mBCG alone
        L = pivoted_cholesky_dense(At, precond_rank)
        p_solve = PivotedCholeskyPreconditioner.build(L, sigma2).solve
        r_solve = RefPrecond.build(jnp.asarray(L.numpy()), jnp.float32(sigma2)).solve
    ours = mbcg(lambda M: At @ M, Bt, precond_solve=p_solve, **kw)
    ref = ref_mbcg(lambda M: Aj @ M, Bj, precond_solve=r_solve, **kw)
    return ours, ref


def _assert_result_matches(ours, ref):
    np.testing.assert_allclose(ours.solves.numpy(), np.asarray(ref.solves), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        ours.tridiag_alpha.numpy(), np.asarray(ref.tridiag_alpha), rtol=1e-3, atol=1e-6
    )
    np.testing.assert_allclose(
        ours.tridiag_beta.numpy(), np.asarray(ref.tridiag_beta), rtol=1e-3, atol=1e-6
    )
    np.testing.assert_array_equal(ours.num_iters.numpy(), np.asarray(ref.num_iters))
    np.testing.assert_array_equal(ours.active_steps.numpy(), np.asarray(ref.active_steps))
    # atol 1e-6: a converged column's final relative residual is f32 noise
    np.testing.assert_allclose(
        ours.residual_norm.numpy(), np.asarray(ref.residual_norm), rtol=1e-3, atol=1e-6
    )
    assert ours.num_refreshes is None and ref.num_refreshes is None


@pytest.mark.parametrize("precond_rank", [0, 4])
@pytest.mark.parametrize("tol", [1e-4, 3e-2])
def test_mbcg_result_field_by_field(precond_rank, tol):
    """Columns freeze at different steps — without a preconditioner one
    lies in a 2-dimensional eigenspace and converges at step 2, and tol=3e-2
    stops the others early — so the per-column masking (α = 0 on frozen columns) must agree step for
    step.  The trip count keeps every live residual well above f32 rounding:
    past that point two correct CG runs that round differently part ways,
    and no tolerance on α would be meaningful."""
    A, rng = _spd(0, 64, 10.0)
    B = rng.standard_normal((64, 6)).astype(np.float32)
    w, V = np.linalg.eigh(A.astype(np.float64))
    B[:, 2] = (V[:, 5] + 2.0 * V[:, 40]).astype(np.float32)
    B[:, 3] *= 1e-3  # a column at a different scale: relative tolerance per column
    ours, ref = _run_both(A, B, precond_rank=precond_rank, max_iters=10, tol=tol)
    _assert_result_matches(ours, ref)
    assert ours.solves.shape == (64, 6)
    assert ours.tridiag_alpha.shape == (6, 10)
    if tol > 1e-3 or not precond_rank:
        assert int(ours.num_iters.min()) < 10  # masking actually happened
    assert torch.all(ours.tridiag_alpha[~ours.active_steps] == 0)


def test_mbcg_return_basis_and_vector_rhs():
    A, rng = _spd(1, 40, 20.0)
    B = rng.standard_normal((40, 3)).astype(np.float32)
    ours, ref = _run_both(A, B, max_iters=12, tol=1e-6, return_basis=True)
    _assert_result_matches(ours, ref)
    assert ours.basis.shape == (40, 3, 12)
    np.testing.assert_allclose(ours.basis.numpy(), np.asarray(ref.basis), rtol=1e-3, atol=1e-5)
    vec, vec_ref = _run_both(A, B[:, 0], max_iters=12, tol=1e-6, return_basis=True)
    assert vec.solves.shape == (40,) and vec.basis.shape == (40, 12)
    np.testing.assert_allclose(vec.solves.numpy(), np.asarray(vec_ref.solves), rtol=1e-4, atol=1e-5)


def test_mbcg_batched_rhs_equals_loop():
    """Leading batch dims run as one loop and equal per-problem runs."""
    A, rng = _spd(2, 32, 10.0)
    B = rng.standard_normal((3, 32, 4)).astype(np.float32)
    At = torch.from_numpy(A)
    batched = mbcg(lambda M: At @ M, torch.from_numpy(B), max_iters=15, tol=1e-5)
    for i in range(3):
        one = mbcg(lambda M: At @ M, torch.from_numpy(B[i]), max_iters=15, tol=1e-5)
        np.testing.assert_allclose(batched.solves[i].numpy(), one.solves.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(batched.num_iters[i].numpy(), one.num_iters.numpy())
    ref = ref_mbcg(lambda M: jnp.asarray(A) @ M, jnp.asarray(B), max_iters=15, tol=1e-5)
    _assert_result_matches(batched, ref)


def test_tridiag_matrices_match_reference():
    A, rng = _spd(3, 48, 30.0)
    B = rng.standard_normal((48, 4)).astype(np.float32)
    ours, ref = _run_both(A, B, max_iters=20, tol=1e-3)
    T = tridiag_matrices(ours)
    assert T.shape == (4, 20, 20)
    np.testing.assert_allclose(T.numpy(), np.asarray(ref_tridiag_matrices(ref)), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(T.numpy(), T.transpose(-1, -2).numpy())


@pytest.mark.parametrize("precond_rank", [0, 4])
def test_slq_logdet_matches_reference(precond_rank):
    """Probes drawn once (the reference's Rademacher draw) and handed to both."""
    A, _ = _spd(4, 80, 40.0)
    sigma2 = 0.5
    Z = np.array(jax.random.rademacher(jax.random.PRNGKey(0), (80, 16), dtype=jnp.float32))
    At = torch.from_numpy(A)
    if precond_rank:
        L = pivoted_cholesky_dense(At, precond_rank)
        P = PivotedCholeskyPreconditioner.build(L, sigma2)
        Pr = RefPrecond.build(jnp.asarray(L.numpy()), jnp.float32(sigma2))
        # probes with covariance P̂, as the engine draws them
        Z = np.array(Pr.sample_probes(jax.random.PRNGKey(0), 16, 80))
        quads, ldet = P.inv_quad(torch.from_numpy(Z)), P.logdet()
        quads_r, ldet_r = Pr.inv_quad(jnp.asarray(Z)), Pr.logdet()
    else:
        quads, ldet = torch.sum(torch.from_numpy(Z) ** 2, dim=0), torch.tensor(0.0)
        quads_r, ldet_r = jnp.sum(jnp.asarray(Z) ** 2, axis=0), jnp.float32(0.0)
    ours, ref = _run_both(A, Z, precond_rank=precond_rank, sigma2=sigma2, max_iters=40, tol=1e-6)
    ld = float(logdet_from_mbcg(ours, quads, ldet))
    ld_ref = float(ref_logdet_from_mbcg(ref, quads_r, ldet_r))
    np.testing.assert_allclose(ld, ld_ref, rtol=1e-3)
    exact = float(np.linalg.slogdet(A.astype(np.float64))[1])
    assert abs(ld - exact) < 0.1 * abs(exact)  # SLQ with 16 probes: a 10% estimate


def test_unported_mbcg_paths_raise():
    """The fused loop with a preconditioner still raises; the f32 residual
    refresh is ported and runs (its counters: tests/test_torch_precision.py)."""
    A, _ = _spd(5, 8, 2.0)
    B = torch.ones(8, 2)
    At = torch.from_numpy(A)
    with pytest.raises(ValueError, match="identity preconditioner"):
        mbcg(lambda M: At @ M, B, fused_step=lambda *a: None, precond_solve=lambda R: R)
    res = mbcg(lambda M: At @ M, B, refresh_every=2, max_iters=6)
    assert int(res.num_refreshes) == 3
    assert int(res.num_rescues) == 0 and int(res.num_curvature_skips) == 0
    torch.testing.assert_close(At @ res.solves, B, rtol=1e-4, atol=1e-4)

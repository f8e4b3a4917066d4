"""The port's fused CG step and fused mBCG loop against the reference's.

The same numpy inputs go through both packages: the reference's Pallas
``fused_cg_step_pallas`` in interpret mode and its ``xla_cg_step``, the
port's ``fused_cg_step_plain`` (what B3 computes) and its CPU-tensor
wrappers.  Tolerances are the reference's (tests/test_fused_cg.py): the
state rtol / atol 2e-4 and the reductions rtol 2e-4 / atol 2e-3
(:84-86); solves rtol 1e-3 / atol 1e-4 and the MLL rtol 1e-4 (:309-311);
the first Lanczos columns rtol 1e-3 / atol 2e-4 (:226).  The B3 kernel
itself is held against ``fused_cg_step_plain`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

Two correct f32 CG runs part ways once residuals get small, so loops are
compared on well-conditioned problems or over their first iterations.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.preconditioner as port_precond
from repro.core import AddedDiagOperator as RefAddedDiag
from repro.core import BBMMSettings as RefSettings
from repro.core import marginal_log_likelihood as ref_mll
from repro.core import mbcg as ref_mbcg
from repro.core import xla_cg_step
from repro.gp import KernelOperator as RefKernelOperator
from repro.gp import MaternKernel as RefMatern
from repro.kernels.kernel_matmul.kernel_matmul import fused_cg_step_pallas
from repro.kernels.kernel_matmul.ref import kernel_matmul_ref as ref_kernel_matmul_ref
from repro_torch import ExactGP
from repro_torch.core import (
    AddedDiagOperator,
    BBMMSettings,
    build_posterior_cache,
    engine_state,
    marginal_log_likelihood,
    mbcg,
    plain_cg_step,
    solve,
)
from repro_torch.gp import KernelOperator, MaternKernel, RBFKernel
from repro_torch.kernels.kernel_matmul.ops import fused_cg_step, fused_cg_step_prescaled
from repro_torch.kernels.kernel_matmul.ref import fused_cg_step_plain, kernel_matmul_plain

STATE_TOL = dict(rtol=2e-4, atol=2e-4)
RED_TOL = dict(rtol=2e-4, atol=2e-3)
SOLVE_TOL = dict(rtol=1e-3, atol=1e-4)


def _step_inputs(seed, n, t, b, d=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32) / 0.6
    state = [rng.standard_normal((b, n, t)).astype(np.float32) for _ in range(4)]
    alpha = rng.standard_normal((b, t)).astype(np.float32)
    beta = (0.5 * rng.standard_normal((b, t))).astype(np.float32)
    return X, state, [alpha, beta, np.ones((b, t), np.float32)]


def _port_plain(X, state, scalars, kt, s=1.3, s2=0.1, off=0, Xr=None):
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    Xr = X if Xr is None else Xr
    st = [T(a) for a in state]
    return fused_cg_step_plain(T(Xr), T(X), *st, *st[1:], *map(T, scalars), s, s2, off,
                               kernel_type=kt)


def _assert_step(ours, ref):
    for a, b, name in zip(ours[:4], ref[:4], "URDV"):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **STATE_TOL, err_msg=name)
    ref_red = np.asarray(ref[4])
    if ref_red.ndim == 2 and np.asarray(ours[4]).ndim == 3:
        ref_red = ref_red[None]
    np.testing.assert_allclose(np.asarray(ours[4]), ref_red, **RED_TOL, err_msg="red")


@pytest.mark.parametrize("kernel_type", ["rbf", "matern32", "matern52"])
@pytest.mark.parametrize("n,t,b", [(64, 4, 1), (100, 5, 1), (100, 3, 2), (257, 5, 2)])
def test_plain_step_matches_reference_pallas_step(kernel_type, n, t, b):
    """fused_cg_step_plain (B3's function) against the reference's fused
    Pallas kernel in interpret mode, at the reference test's shapes."""
    X, state, scalars = _step_inputs(n + t + b, n, t, b)
    ours = _port_plain(X, state, scalars, kernel_type)
    Xj = jnp.asarray(X)
    st = [jnp.asarray(a) for a in state]
    ref = fused_cg_step_pallas(
        Xj, Xj, *st, *st[1:], *map(jnp.asarray, scalars), jnp.float32(1.3), jnp.float32(0.1),
        kernel_type=kernel_type, bn=64, bm=64, interpret=True,
    )
    _assert_step([a.numpy() for a in ours], ref)


@pytest.mark.parametrize("kernel_type", ["rbf", "matern52"])
@pytest.mark.parametrize("b", [None, 2])
def test_plain_step_and_plain_cg_step_match_xla_cg_step(kernel_type, b):
    """The port's two plain steps (fused_cg_step_plain, plain_cg_step over
    the plain matmul, both through the ops wrapper) against the reference's
    xla_cg_step over its dense oracle."""
    n, t = 97, 4
    X, state, scalars = _step_inputs(5, n, t, b or 1)
    if b is None:
        state, scalars = [a[0] for a in state], [a[0] for a in scalars]
    ell = 0.8
    ref_mm = lambda M: ref_kernel_matmul_ref(  # noqa: E731
        jnp.asarray(X), M, ell, 1.3, 0.1, kernel_type=kernel_type)
    ref = xla_cg_step(ref_mm)(*map(jnp.asarray, state), *map(jnp.asarray, scalars))
    ref = (*ref[:4], jnp.stack(ref[4], axis=-2))
    Xs = torch.from_numpy(X / ell)
    st = [torch.from_numpy(a) for a in state]
    sc = [torch.from_numpy(a) for a in scalars]
    wrapped = fused_cg_step_prescaled(Xs, *st, *sc, 1.3, 0.1, kernel_type=kernel_type)
    mm = lambda M: kernel_matmul_plain(Xs, Xs, M, 1.3, 0.1, kernel_type=kernel_type)  # noqa: E731
    twin = plain_cg_step(mm)(*st, *sc)
    for ours in (wrapped, twin):
        _assert_step([a.numpy() for a in ours[:4]] + [torch.stack(ours[4], dim=-2).numpy()], ref)


def test_row_offset_shards_reassemble_the_full_step():
    """Row shards of the fused step (the sharded path's per-device call)
    reassemble to the full step, σ² diagonal at global coordinates, and
    their reductions sum to the full step's."""
    n, t = 121, 4
    X, state, scalars = _step_inputs(12, n, t, 2)
    T = torch.from_numpy
    st, sc = [T(a) for a in state], [T(a) for a in scalars]
    Xs = T(X)
    full = fused_cg_step(Xs, Xs, *st, *st[1:], *sc, 1.2, 0.5, kernel_type="matern32")
    parts = [
        fused_cg_step(Xs[lo:hi], Xs, *[a[:, lo:hi] for a in st], *st[1:], *sc, 1.2, 0.5,
                      lo, kernel_type="matern32")
        for lo, hi in ((0, 40), (40, 80), (80, n))
    ]
    for k in range(4):
        torch.testing.assert_close(torch.cat([p[k] for p in parts], dim=1), full[k],
                                   rtol=1e-5, atol=1e-5)
    for k in range(4):
        torch.testing.assert_close(sum(p[4][k] for p in parts), full[4][k], rtol=1e-5, atol=1e-4)


def test_frozen_noop_and_zero_columns():
    """α = β = γ = 0 keeps a column's U and R; an all-zero column with those
    scalars adds exactly 0 everywhere (so padding needs no stripping); the
    no-op prologue (α=0, β=1, γ=0) leaves U, R, D untouched and recomputes
    V = K̂·D."""
    n, t = 80, 4
    X, state, scalars = _step_inputs(9, n, t, 1)
    st = [torch.from_numpy(a[0]) for a in state]
    Xs = torch.from_numpy(X)
    z = torch.zeros(t)
    a = torch.tensor([0.0, 0.0, 0.3, -0.2])
    b = torch.tensor([0.0, 0.0, 0.5, 0.1])
    g = torch.tensor([0.0, 0.0, 1.0, 1.0])
    st[0][:, 1] = st[1][:, 1] = st[2][:, 1] = st[3][:, 1] = 0.0
    U, R, D, V, red = fused_cg_step_prescaled(Xs, *st, a, b, g, 1.0, 0.1)
    assert torch.equal(U[:, 0], st[0][:, 0]) and torch.equal(R[:, 0], st[1][:, 0])
    assert all(bool((x[:, 1] == 0).all()) for x in (U, R, D, V))
    assert all(float(r[1]) == 0.0 for r in red)
    U, R, D, V, _ = fused_cg_step_prescaled(Xs, *st, z, torch.ones(t), z, 1.0, 0.1)
    assert torch.equal(U, st[0]) and torch.equal(R, st[1]) and torch.equal(D, st[2])
    torch.testing.assert_close(V, kernel_matmul_plain(Xs, Xs, st[2], 1.0, 0.1), **STATE_TOL)


def test_batched_step_matches_per_slice():
    """Leading batch dims flatten onto B3's batch axis and come back."""
    X, state, scalars = _step_inputs(3, 50, 3, 6)
    st = [torch.from_numpy(a).reshape(2, 3, 50, 3) for a in state]
    sc = [torch.from_numpy(a).reshape(2, 3, 3) for a in scalars]
    Xs = torch.from_numpy(X)
    out = fused_cg_step_prescaled(Xs, *st, *sc, 1.0, 0.2)
    assert out[0].shape == (2, 3, 50, 3) and out[4][0].shape == (2, 3, 3)
    one = fused_cg_step_prescaled(Xs, *[a[1, 2] for a in st], *[a[1, 2] for a in sc], 1.0, 0.2)
    for k in range(4):
        torch.testing.assert_close(out[k][1, 2], one[k], rtol=1e-6, atol=1e-6)
    for k in range(4):
        torch.testing.assert_close(out[4][k][1, 2], one[4][k], rtol=1e-6, atol=1e-5)


def _spd(seed, n, cond):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, np.log10(cond), n)
    return ((Q * eigs) @ Q.T).astype(np.float32), rng


@pytest.mark.parametrize("return_basis", [False, True])
def test_fused_mbcg_matches_reference_fused_mbcg(return_basis):
    """The port's fused loop over plain_cg_step against the reference's over
    xla_cg_step, field by field, on a well-conditioned SPD matrix."""
    A, rng = _spd(1, 60, 30.0)
    B = rng.standard_normal((60, 3)).astype(np.float32)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    # tol 5e-4 freezes every column well before the f32 floor, and no
    # column's residual lies within 10 % of it at any step, so rounding
    # cannot move a column across it
    kw = dict(max_iters=40, tol=5e-4, return_basis=return_basis)
    ours = mbcg(lambda M: At @ M, torch.from_numpy(B),
                fused_step=plain_cg_step(lambda M: At @ M), **kw)
    ref = ref_mbcg(lambda M: Aj @ M, jnp.asarray(B), fused_step=xla_cg_step(lambda M: Aj @ M), **kw)
    np.testing.assert_allclose(ours.solves.numpy(), np.asarray(ref.solves), **SOLVE_TOL)
    np.testing.assert_array_equal(ours.num_iters.numpy(), np.asarray(ref.num_iters))
    np.testing.assert_array_equal(ours.active_steps.numpy(), np.asarray(ref.active_steps))
    np.testing.assert_allclose(ours.tridiag_alpha[..., :10].numpy(),
                               np.asarray(ref.tridiag_alpha)[..., :10], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(ours.tridiag_beta[..., :10].numpy(),
                               np.asarray(ref.tridiag_beta)[..., :10], rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(ours.residual_norm.numpy(), np.asarray(ref.residual_norm),
                               rtol=1e-3)
    if return_basis:
        assert ours.basis.shape == ref.basis.shape
        np.testing.assert_allclose(ours.basis[..., :8].numpy(), np.asarray(ref.basis)[..., :8],
                                   rtol=1e-3, atol=2e-4)


def _rbf_op(n=96, d=3, noise=0.1, seed=0, mode="cuda"):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    kern = RBFKernel(lengthscale=torch.tensor(0.6), outputscale=torch.tensor(1.3))
    op = AddedDiagOperator(KernelOperator(kernel=kern, X=X, mode=mode), torch.tensor(noise))
    return op, X, torch.sin(X @ torch.ones(d))


def test_fused_loop_matches_unfused_loop():
    """On the cuda operator (CPU tensors: the plain versions), the fused
    loop's solves and first Lanczos columns against the unfused loop's."""
    op, _, y = _rbf_op(n=72, noise=0.5)
    prepared = op.prepare()
    step = prepared.fused_cg_step_fn()
    assert step is not None
    B = torch.stack([y, torch.cos(2 * y)], dim=-1)
    fused = mbcg(prepared.matmul, B, max_iters=24, tol=1e-6, return_basis=True, fused_step=step)
    plain = mbcg(prepared.matmul, B, max_iters=24, tol=1e-6, return_basis=True)
    torch.testing.assert_close(fused.solves, plain.solves, **SOLVE_TOL)
    torch.testing.assert_close(fused.basis[..., :8], plain.basis[..., :8], rtol=1e-3, atol=2e-4)
    assert fused.basis.shape == plain.basis.shape


def test_engine_fused_matches_unfused():
    op, _, y = _rbf_op()
    s0 = BBMMSettings(num_probes=8, max_cg_iters=64, precond_rank=0, cg_tol=1e-6)
    sf = dataclasses.replace(s0, fuse_cg=True)

    def gen():
        g = torch.Generator()
        g.manual_seed(17)
        return g

    mll_u = marginal_log_likelihood(op, y, gen(), s0)
    mll_f = marginal_log_likelihood(op, y, gen(), sf)
    np.testing.assert_allclose(float(mll_f), float(mll_u), rtol=1e-4)
    st_u, st_f = engine_state(op, y, gen(), s0), engine_state(op, y, gen(), sf)
    torch.testing.assert_close(st_f.solve_y, st_u.solve_y, **SOLVE_TOL)


def test_fused_mll_matches_reference_fused_mll(monkeypatch):
    """The port's fused MLL (cuda operator on CPU tensors) against the
    reference's fused Pallas path (interpret mode), with the reference's
    probes."""
    n, d = 96, 3
    rng = np.random.default_rng(4)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = np.sin(X.sum(-1)).astype(np.float32)
    s = dict(num_probes=6, max_cg_iters=64, precond_rank=0, cg_tol=1e-6, fuse_cg=True)
    key = jax.random.PRNGKey(3)
    Z = np.array(jax.random.rademacher(key, (n, 6), dtype=jnp.float32))
    monkeypatch.setattr(port_precond.IdentityPreconditioner, "sample_probes",
                        lambda self, g, num, n_: torch.from_numpy(Z))
    ref_op = RefAddedDiag(RefKernelOperator(
        kernel=RefMatern(lengthscale=jnp.float32(0.7), outputscale=jnp.float32(1.1), nu=2.5),
        X=jnp.asarray(X), mode="pallas"), jnp.float32(0.2))
    op = AddedDiagOperator(KernelOperator(
        kernel=MaternKernel(lengthscale=torch.tensor(0.7), outputscale=torch.tensor(1.1), nu=2.5),
        X=torch.from_numpy(X), mode="cuda"), torch.tensor(0.2))
    ref = float(ref_mll(ref_op, jnp.asarray(y), key, RefSettings(**s)))
    ours = float(marginal_log_likelihood(op, torch.from_numpy(y), torch.Generator(),
                                         BBMMSettings(**s)))
    np.testing.assert_allclose(ours, ref, rtol=1e-4)


def test_fuse_cg_with_preconditioner_raises():
    """fuse_cg + a real preconditioner is a loud error, never a silent
    fallback (the fused kernel has no preconditioner solve inside)."""
    op, _, y = _rbf_op(n=64)
    s = BBMMSettings(num_probes=4, max_cg_iters=16, precond_rank=5, fuse_cg=True)
    with pytest.raises(ValueError, match="identity preconditioner"):
        marginal_log_likelihood(op, y, torch.Generator(), s)
    with pytest.raises(ValueError, match="precond_rank=0"):
        solve(op, y[:, None], s)
    gp = ExactGP(mode="cuda", fuse_cg=True, device="cpu")
    with pytest.raises(ValueError, match="precond_rank=0"):
        gp.posterior_cache(gp.init_params(3), op.base.X, y)


def test_fuse_cg_without_capability_keeps_the_unfused_loop():
    """dense / blocked operators have no fused step: the same answer as the
    unfused loop, no error; a batched σ² has no scalar tile term."""
    op, _, y = _rbf_op(n=64, mode="dense")
    assert op.fused_cg_step_fn() is None
    s0 = BBMMSettings(num_probes=4, max_cg_iters=32, precond_rank=0, cg_tol=1e-6)
    sf = dataclasses.replace(s0, fuse_cg=True)

    def gen():
        g = torch.Generator()
        g.manual_seed(2)
        return g

    torch.testing.assert_close(marginal_log_likelihood(op, y, gen(), sf),
                               marginal_log_likelihood(op, y, gen(), s0))
    cuda_op, _, _ = _rbf_op(n=64)
    batched = AddedDiagOperator(cuda_op.base, torch.tensor([0.1, 0.2]))
    assert batched.fused_cg_step_fn() is None
    assert cuda_op.fused_cg_step_fn() is not None


def test_fused_posterior_cache_matches_unfused():
    """The fused cache build (B3's path) serves the same mean and keeps
    the same basis width as the unfused one (tests/test_fused_cg.py:218)."""
    op, X, y = _rbf_op(n=72, noise=0.5)
    s0 = BBMMSettings(num_probes=4, max_cg_iters=24, precond_rank=0, cg_tol=1e-5)

    def gen():
        g = torch.Generator()
        g.manual_seed(5)
        return g

    plain = build_posterior_cache(op, y, gen(), s0)
    fused = build_posterior_cache(op, y, gen(), dataclasses.replace(s0, fuse_cg=True))
    assert fused.basis.shape == plain.basis.shape
    torch.testing.assert_close(fused.alpha, plain.alpha, **SOLVE_TOL)
    torch.testing.assert_close(fused.inv_quad, plain.inv_quad, rtol=1e-4, atol=1e-4)


def test_exact_gp_fuse_cg_override():
    gp = ExactGP(mode="cuda", fuse_cg=True, device="cpu",
                 settings=BBMMSettings(precond_rank=0, num_probes=3))
    assert gp.settings.fuse_cg is True and gp.settings.num_probes == 3
    assert ExactGP(device="cpu", settings=BBMMSettings(fuse_cg=True)).settings.fuse_cg
    assert not ExactGP(device="cpu", fuse_cg=False,
                       settings=BBMMSettings(fuse_cg=True)).settings.fuse_cg

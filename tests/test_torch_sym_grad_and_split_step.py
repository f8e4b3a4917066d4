"""The one-X gradient path and B3's two-pass split, against the reference.

* The symmetric VJP (one X on both sides, as in training: the gradient
  kernel's single launch with the weight ⟨Cᵢ, Mⱼ⟩ + ⟨Mᵢ, Cⱼ⟩) has a plain
  twin, ``kernel_matmul_grad_sym_plain``.  Carried through X/ℓ it must give
  the two-sided plain VJP's ℓ-gradient and the reference's ``jax.vjp``
  ℓ-gradient of ``kernel_matmul_ref``.  Tolerance: 2e-4 of each gradient's
  largest entry, the kernel matmul's own (tests/test_kernel_matmul_pallas.py:23).
  Matérn-½ is held to the two-sided plain VJP only: the reference's distance
  expansion carries ~1e-6 on the diagonal of d² (ROADMAP Queue C item 2).
* B3 runs as an advance pass and a product pass; their plain halves
  (``fused_cg_advance_plain``, ``fused_cg_product_plain``) composed must
  equal ``fused_cg_step_plain`` bit for bit, and the reference's fused
  Pallas step (interpret mode) at its tolerances (tests/test_fused_cg.py:84-86),
  also for row shards whose column state is the full one.

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kernel_matmul.kernel_matmul import fused_cg_step_pallas
from repro.kernels.kernel_matmul.ref import kernel_matmul_ref as ref_kernel_matmul_ref
from repro_torch.kernels.kernel_matmul import kernel_matmul as km
from repro_torch.kernels.kernel_matmul.ops import fused_kernel_matmul_prescaled
from repro_torch.kernels.kernel_matmul.ref import (
    fused_cg_advance_plain,
    fused_cg_product_plain,
    fused_cg_step_plain,
    kernel_matmul_grad_plain,
    kernel_matmul_grad_sym_plain,
)

REL = 2e-4
STATE_TOL = dict(rtol=2e-4, atol=2e-4)
RED_TOL = dict(rtol=2e-4, atol=2e-3)


def _close(ours, ref, name=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    assert np.isfinite(ours).all(), name
    err = np.abs(ours - ref).max()
    assert err <= REL * max(np.abs(ref).max(), 1e-30), f"{name}: max |Δ| {err:.3e}"


def _inputs(seed, n, d, t, ard):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    X[n // 2] = X[1]  # coincident points off the diagonal
    M = rng.standard_normal((n, t)).astype(np.float32)
    C = rng.standard_normal((n, t)).astype(np.float32)
    ell = rng.uniform(0.5, 1.5, d).astype(np.float32) if ard else np.float32(0.8)
    return X, M, C, ell


def _through_lengthscale(X, ell, grad_x):
    """(X/ℓ, ℓ-gradient of ⟨G, X/ℓ⟩) for the G that ``grad_x`` returns."""
    ell_t = torch.tensor(ell, requires_grad=True)
    Xs = torch.from_numpy(X) / ell_t
    g = grad_x(Xs.detach())
    (g_ell,) = torch.autograd.grad(Xs, ell_t, g)
    return g_ell.numpy()


@pytest.mark.parametrize("kernel_type", ["rbf", "matern12", "matern32", "matern52"])
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("n,t", [(37, 1), (101, 5)])
def test_sym_plain_vjp_matches_two_sided_and_jax_vjp(kernel_type, ard, n, t):
    X, M, C, ell = _inputs(n + 3 * t, n, 4, t, ard)
    s, s2 = np.float32(1.3), np.float32(0.2)
    Mt, Ct = torch.from_numpy(M), torch.from_numpy(C)
    Xs = torch.from_numpy(X / ell)
    sym = kernel_matmul_grad_sym_plain(Xs, Mt, Ct, s, s2, kernel_type=kernel_type)
    two = kernel_matmul_grad_plain(Xs, Xs, Mt, Ct, s, s2, kernel_type=kernel_type)
    _close(sym[0], two[0] + two[1], "X")
    _close(sym[1], two[2], "outputscale")
    _close(sym[2], two[3], "sigma2")

    g_sym = _through_lengthscale(X, ell, lambda x: kernel_matmul_grad_sym_plain(
        x, Mt, Ct, s, s2, kernel_type=kernel_type)[0])
    g_two = _through_lengthscale(X, ell, lambda x: sum(kernel_matmul_grad_plain(
        x, x, Mt, Ct, s, s2, kernel_type=kernel_type)[:2]))
    _close(g_sym, g_two, "lengthscale vs two-sided")
    if kernel_type == "matern12":
        return
    _, vjp = jax.vjp(
        lambda l_, s_, s2_: ref_kernel_matmul_ref(jnp.asarray(X), jnp.asarray(M), l_, s_, s2_,
                                                  kernel_type=kernel_type),
        jnp.asarray(ell), jnp.asarray(s), jnp.asarray(s2),
    )
    ref_ell, ref_s, ref_s2 = vjp(jnp.asarray(C))
    _close(g_sym, ref_ell, "lengthscale vs jax.vjp")
    _close(sym[1], ref_s, "outputscale vs jax.vjp")
    _close(sym[2], ref_s2, "sigma2 vs jax.vjp")


@pytest.mark.parametrize("kernel_type", ["rbf", "matern52"])
def test_one_x_routes_to_the_symmetric_function(kernel_type):
    """``fused_kernel_matmul_prescaled`` takes SymKernelMatmulFn for one X
    tensor at row_offset 0 and KernelMatmulFn otherwise; both give the same
    gradients for X, M, the outputscale and σ²."""
    X, M, C, _ = _inputs(4, 53, 3, 4, False)
    grads = {}
    for route in ("sym", "equal copies", "row_offset"):
        Xl = torch.from_numpy(X).requires_grad_()
        Ml = torch.from_numpy(M).requires_grad_()
        s = torch.tensor(1.1, requires_grad=True)
        s2 = torch.tensor(0.3, requires_grad=True)
        if route == "sym":
            out = fused_kernel_matmul_prescaled(Xl, Xl, Ml, s, s2, kernel_type=kernel_type)
            assert type(out.grad_fn).__name__ == "SymKernelMatmulFnBackward"
        elif route == "equal copies":
            out = fused_kernel_matmul_prescaled(Xl, Xl * 1.0, Ml, s, s2, kernel_type=kernel_type)
            assert type(out.grad_fn).__name__ == "KernelMatmulFnBackward"
        else:
            # the last 13 rows as a shard of the full X: row_offset 40
            out = torch.cat([
                fused_kernel_matmul_prescaled(Xl[:40], Xl, Ml, s, s2, kernel_type=kernel_type),
                fused_kernel_matmul_prescaled(Xl[40:], Xl, Ml, s, s2, 40, kernel_type=kernel_type),
            ])
        out.backward(torch.from_numpy(C))
        grads[route] = [v.grad.numpy() for v in (Xl, Ml, s, s2)]
    for route in ("equal copies", "row_offset"):
        for a, b, name in zip(grads["sym"], grads[route], ("X", "M", "outputscale", "sigma2")):
            _close(a, b, f"{route} d/d{name}")


def test_sym_grad_wrapper_on_cpu_is_the_plain_twin():
    X, M, C, _ = _inputs(6, 40, 3, 3, False)
    Xt, Mt, Ct = (torch.from_numpy(a) for a in (X, M, C))
    before = km.grad_launches
    ours = km.kernel_matmul_grad_sym_cuda(Xt, Mt, Ct, 1.0, 0.5, kernel_type="matern32")
    plain = kernel_matmul_grad_sym_plain(Xt, Mt, Ct, 1.0, 0.5, kernel_type="matern32")
    assert km.grad_launches == before  # no kernel on CPU tensors
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)


def _step_inputs(seed, n, t, b, d=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32) / 0.6
    state = [rng.standard_normal((b, n, t)).astype(np.float32) for _ in range(4)]
    alpha = rng.standard_normal((b, t)).astype(np.float32)
    beta = (0.5 * rng.standard_normal((b, t))).astype(np.float32)
    return X, state, [alpha, beta, np.ones((b, t), np.float32)]


def _split(Xr, Xc, state, cols, scalars, kt, s, s2, off=0):
    U, R, D, Dc = fused_cg_advance_plain(*state, *cols, *scalars)
    V, red = fused_cg_product_plain(Xr, Xc, R, D, Dc, s, s2, off, kernel_type=kt)
    return U, R, D, V, red


@pytest.mark.parametrize("kernel_type", ["rbf", "matern32", "matern52"])
@pytest.mark.parametrize("n,t,b", [(64, 4, 1), (100, 5, 1), (257, 5, 2)])
def test_split_plain_step_matches_fused_plain_step_and_reference(kernel_type, n, t, b):
    X, state, scalars = _step_inputs(n + 7 * t + b, n, t, b)
    T = torch.from_numpy
    Xs, st, sc = T(X), [T(a) for a in state], [T(a) for a in scalars]
    ours = _split(Xs, Xs, st, st[1:], sc, kernel_type, 1.3, 0.1)
    whole = fused_cg_step_plain(Xs, Xs, *st, *st[1:], *sc, 1.3, 0.1, kernel_type=kernel_type)
    for a, w in zip(ours, whole):
        assert torch.equal(a, w)
    Xj = jnp.asarray(X)
    stj = [jnp.asarray(a) for a in state]
    ref = fused_cg_step_pallas(
        Xj, Xj, *stj, *stj[1:], *map(jnp.asarray, scalars), jnp.float32(1.3), jnp.float32(0.1),
        kernel_type=kernel_type, bn=64, bm=64, interpret=True,
    )
    for a, r, name in zip(ours[:4], ref[:4], "URDV"):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **STATE_TOL, err_msg=name)
    np.testing.assert_allclose(ours[4].numpy(), np.asarray(ref[4]), **RED_TOL, err_msg="red")


def test_split_row_shards_with_the_full_column_state_reassemble():
    """Row shards advance their own rows and the full column state (B3's
    scratch D′), then multiply at their row_offset: the rows and the summed
    reductions of the full step."""
    n, t = 121, 4
    X, state, scalars = _step_inputs(12, n, t, 2)
    T = torch.from_numpy
    Xs, st, sc = T(X), [T(a) for a in state], [T(a) for a in scalars]
    full = fused_cg_step_plain(Xs, Xs, *st, *st[1:], *sc, 1.2, 0.5, kernel_type="matern32")
    parts = [
        _split(Xs[lo:hi], Xs, [a[:, lo:hi] for a in st], st[1:], sc, "matern32", 1.2, 0.5, lo)
        for lo, hi in ((0, 40), (40, 80), (80, n))
    ]
    for k in range(4):
        torch.testing.assert_close(torch.cat([p[k] for p in parts], dim=1), full[k],
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(p[4] for p in parts), full[4], rtol=1e-5, atol=1e-4)

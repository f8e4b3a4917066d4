"""The gradient of the port's kernel matmul against the reference's.

The port differentiates K̂·M with a hand-written kernel (its plain version,
``kernel_matmul_grad_plain``, on CPU tensors); the reference with
``jax.vjp``.  The same numpy inputs go through ``jax.vjp`` of the
reference's ``kernel_matmul_ref`` and through the port's differentiable
``fused_kernel_matmul`` (``KernelMatmulFn``, whose backward is the gradient
wrapper), and through the port's dense operator.  Tolerance: 2e-4 of each
gradient's largest entry, the kernel matmul's own tolerance
(tests/test_kernel_matmul_pallas.py:23).

Matérn-½ is held to a float64 evaluation instead: the reference's
distance expansion leaves ~1e-6 on the diagonal of d², and Matérn-½'s
unbounded derivative at 0 turns that into gradient errors far above the
tolerance (ROADMAP Queue C item 2).  The CUDA kernel is held against the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import ctypes
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kernel_matmul.ref import kernel_matmul_ref as ref_kernel_matmul_ref
from repro_torch.core import AddedDiagOperator
from repro_torch.gp import KernelOperator, MaternKernel, RBFKernel
from repro_torch.kernels import build
from repro_torch.kernels.kernel_matmul import kernel_matmul as km
from repro_torch.kernels.kernel_matmul.ops import fused_kernel_matmul
from repro_torch.kernels.kernel_matmul.ref import kernel_matmul_grad_plain


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


REL = 2e-4
NU = {"matern12": 0.5, "matern32": 1.5, "matern52": 2.5}


def _close(ours, ref, name=""):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    assert np.isfinite(ours).all(), name
    err = np.abs(ours - ref).max()
    assert err <= REL * max(np.abs(ref).max(), 1e-30), f"{name}: max |Δ| {err:.3e}"


def _inputs(seed, n, d, t, ard):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    M = rng.standard_normal((n, t)).astype(np.float32)
    C = rng.standard_normal((n, t)).astype(np.float32)
    ell = rng.uniform(0.5, 1.5, d).astype(np.float32) if ard else np.float32(0.8)
    return X, M, C, ell


def _port_grads(X, M, C, ell, s, s2, kt):
    """∂⟨C, (K + σ²I)M⟩ for X, ℓ, outputscale, σ² through the port's
    differentiable kernel matmul (CPU tensors: the plain gradient)."""
    leaves = [torch.tensor(v, requires_grad=True) for v in (X, ell, s, s2)]
    out = fused_kernel_matmul(leaves[0], torch.from_numpy(M), *leaves[1:], kernel_type=kt)
    out.backward(torch.from_numpy(C))
    return [v.grad.numpy() for v in leaves]


def _oracle_f64(X, M, C, ell, s, s2, kt):
    """The same gradients by autograd through a float64 evaluation whose
    distances come from differences (exactly 0 at coincident points)."""
    leaves = [torch.tensor(np.asarray(v, np.float64), requires_grad=True) for v in (X, ell, s, s2)]
    Xs = leaves[0] / leaves[1]
    d2 = ((Xs[:, None, :] - Xs[None, :, :]) ** 2).sum(-1)
    if kt == "rbf":
        K = torch.exp(-0.5 * d2)
    else:
        a = math.sqrt(2 * NU[kt]) * torch.sqrt(torch.clamp(d2, min=1e-20))
        poly = {"matern12": 1.0, "matern32": 1.0 + a, "matern52": 1.0 + a + a * a / 3.0}[kt]
        K = poly * torch.exp(-a)
    K = leaves[2] * K + leaves[3] * torch.eye(X.shape[0], dtype=torch.float64)
    (K @ torch.from_numpy(M).double()).backward(torch.from_numpy(C).double())
    return [v.grad.numpy() for v in leaves]


@pytest.mark.parametrize("kernel_type", ["rbf", "matern32", "matern52"])
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("n,t", [(37, 1), (101, 5)])
def test_grad_matches_jax_vjp_of_reference(kernel_type, ard, n, t):
    X, M, C, ell = _inputs(n + t, n, 4, t, ard)
    s, s2 = np.float32(1.3), np.float32(0.2)
    _, vjp = jax.vjp(
        lambda X_, l_, s_, s2_: ref_kernel_matmul_ref(X_, jnp.asarray(M), l_, s_, s2_,
                                                      kernel_type=kernel_type),
        jnp.asarray(X), jnp.asarray(ell), jnp.asarray(s), jnp.asarray(s2),
    )
    ref = vjp(jnp.asarray(C))
    ours = _port_grads(X, M, C, ell, s, s2, kernel_type)
    for a, b, name in zip(ours, ref, ("X", "lengthscale", "outputscale", "sigma2")):
        _close(a, b, f"{kernel_type} d/d{name}")


@pytest.mark.parametrize("kernel_type", ["rbf", "matern12", "matern32", "matern52"])
@pytest.mark.parametrize("ard", [False, True])
def test_grad_matches_f64_with_coincident_points(kernel_type, ard):
    """Duplicated rows (coincident points off the diagonal as well as on
    it): finite gradients, no NaN from Matérn-½'s unbounded f′ at r = 0."""
    X, M, C, ell = _inputs(3, 61, 3, 4, ard)
    X[10] = X[3]
    X[40] = X[3]
    ours = _port_grads(X, M, C, ell, np.float32(0.9), np.float32(0.1), kernel_type)
    ref = _oracle_f64(X, M, C, ell, 0.9, 0.1, kernel_type)
    for a, b, name in zip(ours, ref, ("X", "lengthscale", "outputscale", "sigma2")):
        _close(a, b, f"{kernel_type} d/d{name}")


@pytest.mark.parametrize("kernel_type", ["rbf", "matern32", "matern52"])
def test_cuda_operator_grad_matches_dense_operator(kernel_type):
    """⟨C, K̂M⟩ through KernelOperator(mode="cuda") — the prepared operator
    and the differentiable kernel matmul — against mode="dense" (torch
    autograd through the materialized K), for an ARD ℓ, the outputscale
    and σ²."""
    X, M, C, _ = _inputs(8, 83, 3, 3, True)
    grads = {}
    for mode in ("dense", "cuda"):
        ell = torch.tensor([0.6, 0.9, 1.3], requires_grad=True)
        s = torch.tensor(1.1, requires_grad=True)
        s2 = torch.tensor(0.3, requires_grad=True)
        kern = (RBFKernel(ell, s) if kernel_type == "rbf"
                else MaternKernel(ell, s, nu=NU[kernel_type]))
        op = AddedDiagOperator(KernelOperator(kernel=kern, X=torch.from_numpy(X), mode=mode), s2)
        op.matmul(torch.from_numpy(M)).backward(torch.from_numpy(C))
        grads[mode] = [ell.grad, s.grad, s2.grad]
    for a, b, name in zip(grads["cuda"], grads["dense"], ("lengthscale", "outputscale", "sigma2")):
        _close(a.numpy(), b.numpy(), name)


def test_rhs_grad_with_row_offset():
    """Where M needs a gradient, KernelMatmulFn's backward runs the matmul
    with X1 and X2 swapped, plus σ² on the shifted rows."""
    X, M, C, ell = _inputs(11, 70, 3, 2, False)
    Xs = torch.from_numpy(X / ell)
    rows = slice(20, 50)
    Mt = torch.from_numpy(M).requires_grad_()
    out = km.KernelMatmulFn.apply(Xs[rows].contiguous(), Xs, Mt, torch.tensor(1.2),
                                  torch.tensor(0.4), 20, "matern52")
    out.backward(torch.from_numpy(C[rows]))
    d = torch.cdist(Xs[rows].double(), Xs.double())
    a = math.sqrt(5.0) * d
    K = 1.2 * (1.0 + a + a * a / 3.0) * torch.exp(-a)
    K[torch.arange(30), torch.arange(20, 50)] += 0.4
    _close(Mt.grad.numpy(), (K.T @ torch.from_numpy(C[rows]).double()).numpy(), "M")


def test_grad_wrapper_on_cpu_is_the_plain_version():
    X, M, C, _ = _inputs(4, 40, 3, 3, False)
    X1, X2 = torch.from_numpy(X[:25]), torch.from_numpy(X)
    Mt, Ct = torch.from_numpy(M), torch.from_numpy(C[:25])
    before = km.grad_launches
    ours = km.kernel_matmul_grad_cuda(X1, X2, Mt, Ct, 1.0, 0.5, 7, kernel_type="rbf")
    plain = kernel_matmul_grad_plain(X1, X2, Mt, Ct, 1.0, 0.5, 7, kernel_type="rbf")
    assert km.grad_launches == before  # no kernel on CPU tensors
    for a, b in zip(ours, plain):
        assert torch.equal(a, b)
    assert km.kernel_matmul_grad_cuda(X1, X2, Mt, Ct, 1.0, 0.5, 7, kernel_type="rbf",
                                      need_cols=False)[1] is None
    # σ²'s gradient is the trace term Σᵢ ⟨Cᵢ, M_{7+i}⟩
    torch.testing.assert_close(ours[3], (Ct * Mt[7:32]).sum())


@pytest.mark.parametrize("name", ["fused_cg_step", "kernel_matmul_grad"])
def test_ctypes_signatures_match_the_new_entry_points(name):
    """B3's and the gradient kernel's argtypes follow their sources'
    extern "C" signatures, one for one, with every pointer (and the stream)
    as c_void_p (B1's: tests/test_torch_kernel_matmul.py)."""
    symbol, argtypes = build.ENTRY_POINTS[name]
    src = build.source(name).read_text()
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', src).group(1)
    expected = []
    for param in params.split(","):
        assert "*" in param or param.split()[0] == "int", param
        expected.append(ctypes.c_void_p if "*" in param else ctypes.c_int)
    assert argtypes == expected


def test_library_names_hash_every_source_and_header(monkeypatch, tmp_path):
    """Editing any source or the shared header renames every library, so a
    stale build is never loaded."""
    for src in build._csrc_files():
        dst = tmp_path / src.relative_to(build.KERNELS_DIR)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "KERNELS_DIR", tmp_path)
    before = {name: build._library_path(name) for name in build.ENTRY_POINTS}
    assert len({p.name.split("-")[1] for p in before.values()}) == 1
    header = tmp_path / "kernel_matmul" / "csrc" / "common.cuh"
    header.write_text(header.read_text() + "\n// edit\n")
    after = {name: build._library_path(name) for name in build.ENTRY_POINTS}
    assert all(before[k] != after[k] for k in before)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor CUDA (the meta device) is refused,
    never run on some other path."""
    X = torch.empty((8, 2), device="meta")
    S = torch.empty((1, 8, 3), device="meta")
    a = torch.empty((1, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        km.fused_cg_step_cuda(X, X, S, S, S, S, S, S, S, a, a, a, 1.0, 0.0)
    with pytest.raises(ValueError, match="CUDA device"):
        km.kernel_matmul_grad_cuda(X, X, S[0], S[0], 1.0, 0.0)

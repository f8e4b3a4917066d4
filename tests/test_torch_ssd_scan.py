"""The port's SSD scan (B5) and decode step against the reference's.

Inputs are made from a seed with numpy and go through both packages: the
reference's Pallas kernel in interpret mode (``ssd_scan_pallas(...,
interpret=True)``), its step recurrence ``ssd_scan_ref`` and its decode
step; the port's dispatch on CPU tensors (which runs the plain chunked
version), its recurrence and its decode step.  The cases and tolerances
are those of tests/test_flash_ssd_pallas.py:59-126: 2e-3 in f32 (3e-3 for
the shape sweep), 5e-2 with bf16 x.

The CUDA kernel itself is held against the plain versions on the card by
``tests/test_torch_cuda.py`` (which imports no JAX) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_decode_step as ref_decode_step
from repro.kernels.ssd_scan.ref import ssd_scan_chunked_ref as ref_chunked
from repro.kernels.ssd_scan.ref import ssd_scan_ref as ref_recurrence
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
from repro_torch.kernels.ssd_scan import (
    ssd_decode_step,
    ssd_scan_chunked_ref,
    ssd_scan_cuda,
    ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan.ops import ssd_scan


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = dict(rtol=2e-3, atol=2e-3)


def _softplus(x):
    return np.logaddexp(x, 0.0)


def ssd_inputs(seed, b=2, h=3, l=128, dh=16, ds=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, l, dh)).astype(np.float32)
    dt = _softplus(rng.standard_normal((b, h, l)) - 1.0).astype(np.float32)
    A = (-_softplus(rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, l, ds)).astype(np.float32)
    C = rng.standard_normal((b, l, ds)).astype(np.float32)
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_chunked_equals_recurrence():
    args = ssd_inputs(0)
    ours = ssd_scan_chunked_ref(*_t(*args), chunk=32).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref_recurrence(*_j(*args))), **TOL)
    np.testing.assert_allclose(ours, np.asarray(ref_chunked(*_j(*args), chunk=32)), **TOL)


def test_recurrence_matches_the_reference_recurrence():
    args = ssd_inputs(5, l=64)
    np.testing.assert_allclose(ssd_scan_ref(*_t(*args)).numpy(),
                               np.asarray(ref_recurrence(*_j(*args))), rtol=1e-5, atol=1e-5)


def test_recurrence_computes_in_f64_for_f64_inputs():
    """f64 inputs stay f64 (the witness chip_smoke.py holds B5 to): the
    recurrence matches a numpy f64 loop to 1e-12."""
    x, dt, A, B, C = (a.astype(np.float64) for a in ssd_inputs(6, l=48))
    state = np.zeros(x.shape[:2] + (x.shape[-1], B.shape[-1]))
    ys = []
    for t in range(x.shape[2]):
        decay = np.exp(dt[:, :, t] * A[None, :])[..., None, None]
        state = decay * state + dt[:, :, t, None, None] * x[:, :, t, :, None] * B[:, None, None, t]
        ys.append(np.einsum("bhds,bs->bhd", state, C[:, t]))
    ours = ssd_scan_ref(*_t(x, dt, A, B, C))
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), np.stack(ys, axis=2), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_matches_reference_kernel_and_recurrence(chunk):
    args = ssd_inputs(1, l=256)
    ours = ssd_scan(*_t(*args), chunk=chunk).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref_recurrence(*_j(*args))), **TOL)
    kernel = ssd_scan_pallas(*_j(*args), chunk=chunk, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(kernel), **TOL)


def test_dtype_bf16():
    x, dt, A, B, C = ssd_inputs(2, l=128)
    ref = np.asarray(ref_recurrence(*_j(x, dt, A, B, C)))
    kernel = ssd_scan_pallas(jnp.asarray(x).astype(jnp.bfloat16), *_j(dt, A, B, C),
                             chunk=64, interpret=True)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ours = ssd_scan(xb, *_t(dt, A, B, C), chunk=64)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(kernel.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("b,h,l,dh,ds", [(1, 1, 64, 8, 4), (2, 4, 192, 32, 16), (1, 2, 128, 64, 64)])
def test_shape_sweep(b, h, l, dh, ds):
    args = ssd_inputs(3, b, h, l, dh, ds)
    ours = ssd_scan(*_t(*args), chunk=64).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref_recurrence(*_j(*args))), rtol=3e-3, atol=3e-3)
    kernel = ssd_scan_pallas(*_j(*args), chunk=64, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(kernel), rtol=3e-3, atol=3e-3)


def test_decode_step_consistent_with_scan():
    """The recurrent decode step over a sequence equals the scan — the
    train/serve consistency invariant — and the reference's decode step."""
    x, dt, A, B, C = ssd_inputs(4, b=1, h=2, l=16, dh=8, ds=4)
    state = torch.zeros((1, 2, 8, 4))
    rstate = jnp.zeros((1, 2, 8, 4))
    ys = []
    for t in range(16):
        state, y = ssd_decode_step(state, *_t(x[:, :, t], dt[:, :, t], A, B[:, t], C[:, t]))
        rstate, ry = ref_decode_step(rstate, *_j(x[:, :, t], dt[:, :, t], A, B[:, t], C[:, t]))
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5, atol=1e-5)
        ys.append(y)
    out = torch.stack(ys, dim=2).numpy()
    np.testing.assert_allclose(out, np.asarray(ref_recurrence(*_j(x, dt, A, B, C))), **TOL)
    np.testing.assert_allclose(out, ssd_scan(*_t(x, dt, A, B, C), chunk=8).numpy(), **TOL)


def test_strided_views_are_taken_as_they_are():
    """The Mamba-2 block hands over slices and transposes of one projection."""
    x, dt, A, B, C = ssd_inputs(6, b=2, h=4, l=64, dh=8, ds=4)
    xv = torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
    dtv = torch.from_numpy(dt).transpose(1, 2).contiguous().transpose(1, 2)
    BC = torch.from_numpy(np.concatenate([B, C], axis=-1))
    ours = ssd_scan(xv, dtv, torch.from_numpy(A), BC[..., :4], BC[..., 4:], chunk=16)
    torch.testing.assert_close(ours, ssd_scan(*_t(x, dt, A, B, C), chunk=16), rtol=0, atol=0)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    args = _t(*ssd_inputs(7, l=64))
    before = ssd_mod.launches
    ours = ssd_scan_cuda(*args, chunk=32)
    assert ssd_mod.launches == before
    assert torch.equal(ours, ssd_scan_chunked_ref(*args, chunk=32))
    assert torch.equal(ssd_scan(*args, chunk=32, use_kernel=False), ours)


def test_length_must_be_a_multiple_of_the_chunk():
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(*_t(*ssd_inputs(8, l=48)), chunk=32)


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    x = torch.empty((1, 2, 32, 8), device="meta")
    dt = torch.empty((1, 2, 32), device="meta")
    A = torch.empty((2,), device="meta")
    B = torch.empty((1, 32, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan_cuda(x, dt, A, B, B, chunk=32)


def test_cuda_core_layout_slices_only_wide_states():
    """The CUDA-core kernel's whole-state layout fits a block at zamba2's
    ds = 64 (so its calls keep ``ssd_scan_kernel``) and not at mamba2-370m's
    ds = 128 at chunk 128, where the kernel stages the state in slices (the
    library's widths and sizes: ``test_torch_cuda.py``)."""
    assert ssd_mod.shared_bytes(128, 64, 64) == 184_320 <= ssd_mod.MAX_SHARED_BYTES
    assert ssd_mod.shared_bytes(128, 64, 128) == 266_752 > ssd_mod.MAX_SHARED_BYTES
    assert ssd_mod.shared_bytes(256, 64, 64) > ssd_mod.MAX_SHARED_BYTES


def _sliced_scan(x, dt, A, B, C, *, chunk, width):
    """The order of ``ssd_scan_split_kernel``'s work per chunk, in f64: the
    coefficients, then per state slice G += C_s·B_sᵀ, Y += C_s·H_s (H
    before the chunk) and H_s's update, then M = G ∘ decay ∘ dt and
    y = M·x + exp(cum) ∘ Y."""
    b, h, l, dh = x.shape
    ds = B.shape[-1]
    la = dt.double() * A.double()[None, :, None]
    H = torch.zeros((b, h, ds, dh), dtype=torch.float64)
    ys = []
    for c0 in range(0, l, chunk):
        xc, lac, dtc = x[:, :, c0 : c0 + chunk].double(), la[..., c0 : c0 + chunk], dt[..., c0 : c0 + chunk].double()
        cum = torch.cumsum(lac, dim=-1)
        below = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool), diagonal=-1)
        seg = torch.cumsum(torch.where(below, lac[..., :, None], 0.0), dim=-2)
        coef = torch.exp(seg[..., -1, :]) * dtc
        G = torch.zeros((b, chunk, chunk), dtype=torch.float64)
        Y = torch.zeros((b, h, chunk, dh), dtype=torch.float64)
        for s0 in range(0, ds, width):
            Cs = C[:, c0 : c0 + chunk, s0 : s0 + width].double()
            Bs = B[:, c0 : c0 + chunk, s0 : s0 + width].double()
            G = G + Cs @ Bs.transpose(1, 2)
            Y = Y + torch.einsum("bis,bhsp->bhip", Cs, H[:, :, s0 : s0 + width])
            H[:, :, s0 : s0 + width] = (torch.exp(cum[..., -1])[..., None, None] * H[:, :, s0 : s0 + width]
                                        + torch.einsum("bjs,bhj,bhjp->bhsp", Bs, coef, xc))
        M = G[:, None] * torch.exp(seg) * torch.tril(torch.ones((chunk, chunk))) * dtc[..., None, :]
        ys.append(M @ xc + torch.exp(cum)[..., None] * Y)
    return torch.cat(ys, dim=2)


def test_sliced_state_order_is_the_scan():
    """The sliced kernel's order of work (above) gives the scan: against the
    f64 recurrence, at three slices of a 40-wide state (16, 16, 8)."""
    x, dt, A, B, C = _t(*ssd_inputs(9, 1, 2, 64, 8, 40))
    out = _sliced_scan(x, dt, A, B, C, chunk=16, width=16)
    exact = ssd_scan_ref(*(t.double() for t in (x, dt, A, B, C)))
    np.testing.assert_allclose(out.numpy(), exact.numpy(), rtol=1e-10, atol=1e-10)

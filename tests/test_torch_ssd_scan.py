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

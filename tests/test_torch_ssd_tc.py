"""The tensor-core route of the port's SSD scan (B5), on the CPU.

The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).  What the CPU can hold:

* the route rule, ``ssd_scan.b5_route`` — the mirror of the entry point's
  ``tc::takes`` — on aligned and unaligned views, f32, and dh, ds and
  chunks that are not multiples of 16;
* the route's shared memory, ``tc_shared_bytes``, against the layout in
  the source and against the 232,448 bytes a block may use;
* the plain-torch mirror of the kernel's arithmetic — its blocked decay
  sums (``ssd_tc_decays``) and its bf16 high / low splits of M, the state
  and coef∘B with f32 accumulation (``ssd_scan_tc_ref``) — against float64
  and against the reference's Pallas kernel in interpret mode, at the
  reference's tolerances (tests/test_flash_ssd_pallas.py:73,85: 2e-3 in
  f32, 3e-3 for the shape sweep, 5e-2 in bf16).

Inputs are made from a seed with numpy and go through both packages.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ref import ssd_scan_ref as ref_recurrence
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro_torch.kernels.build import source
from repro_torch.kernels.ssd_scan import ssd_scan as ssd
from repro_torch.kernels.ssd_scan.ref import (
    _split_bf16,
    ssd_scan_chunked_ref,
    ssd_scan_ref,
    ssd_scan_tc_ref,
    ssd_tc_decays,
)

TOL = dict(rtol=2e-3, atol=2e-3)
SWEEP_TOL = dict(rtol=3e-3, atol=3e-3)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
BLOCK_SHARED_BYTES = 232_448
SM_SHARED_BYTES = 233_472  # 228 KB an SM, 1 KB of it reserved per resident block


def _softplus(x):
    return np.logaddexp(x, 0.0)


def ssd_inputs(seed, b=2, h=3, l=128, dh=16, ds=16, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, l, dh)).astype(np.float32)
    dt = (dt_scale * _softplus(rng.standard_normal((b, h, l)) - 1.0)).astype(np.float32)
    A = (-_softplus(rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, l, ds)).astype(np.float32)
    C = rng.standard_normal((b, l, ds)).astype(np.float32)
    return x, dt, A, B, C


def _t(*arrays, dtype=None):
    out = [torch.from_numpy(a) for a in arrays]
    return [t.to(dtype) for t in out] if dtype is not None else out


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _f64(*tensors):
    return [t.double() for t in tensors]


# --------------------------------------------------------------------------
# the route
# --------------------------------------------------------------------------


def _model_views(b=2, h=4, l=256, dh=64, ds=64):
    """x, B, C as slices of one (b, l, h·dh + 2·ds) bf16 buffer and dt the
    (b, l, h) projection transposed, as the Mamba-2 block passes them."""
    di = h * dh
    xBC = torch.zeros((b, l, di + 2 * ds), dtype=torch.bfloat16)
    x = xBC[..., :di].reshape(b, l, h, dh).transpose(1, 2)
    dt = torch.zeros((b, l, h)).transpose(1, 2)
    return x, dt, torch.zeros(h), xBC[..., di : di + ds], xBC[..., di + ds :]


def _contiguous(b=2, h=3, l=256, dh=64, ds=64, dtype=torch.bfloat16):
    return (torch.zeros((b, h, l, dh), dtype=dtype), torch.zeros((b, h, l)), torch.zeros(h),
            torch.zeros((b, l, ds), dtype=dtype), torch.zeros((b, l, ds), dtype=dtype))


def _unaligned():
    """x, B and C one element into wider buffers: rows 65 elements apart."""
    x, dt, A, _, _ = _contiguous()
    wide = torch.zeros((2, 3, 256, 65), dtype=torch.bfloat16)
    BC = torch.zeros((2, 256, 129), dtype=torch.bfloat16)
    return wide[..., 1:], dt, A, BC[..., 1:65], BC[..., 65:]


def _single_batch_odd_stride():
    """A size-1 batch dim with a stride that is not 16-byte aligned: never
    stepped, so it does not matter."""
    buf = torch.zeros((3 * 256 * 64 + 8,), dtype=torch.bfloat16)
    x = buf[: 3 * 256 * 64].view(1, 3, 256, 64).as_strided((1, 3, 256, 64), (7, 256 * 64, 64, 1))
    BC = torch.zeros((256, 128), dtype=torch.bfloat16)
    B = BC[:, :64].as_strided((1, 256, 64), (3, 128, 1))
    C = BC[:, 64:].as_strided((1, 256, 64), (3, 128, 1))
    return x, torch.zeros((1, 3, 256)), torch.zeros(3), B, C


ROUTE_CASES = {
    "contiguous bf16": (lambda: _contiguous(), 128, "tensor cores"),
    "the model's strided views": (lambda: _model_views(), 128, "tensor cores"),
    "chunk 32, dh 32, ds 16": (lambda: _contiguous(dh=32, ds=16), 32, "tensor cores"),
    "a size-1 batch with an odd stride": (_single_batch_odd_stride, 128, "tensor cores"),
    "dh = ds = 128 at chunk 64": (lambda: _contiguous(dh=128, ds=128), 64, "tensor cores"),
    "f32": (lambda: _contiguous(dtype=torch.float32), 128, "cuda cores"),
    "rows one element into a wider buffer": (_unaligned, 128, "cuda cores"),
    "dh 40": (lambda: _contiguous(dh=40), 128, "cuda cores"),
    "dh 8, ds 4": (lambda: _contiguous(dh=8, ds=4), 64, "cuda cores"),
    "ds 24": (lambda: _contiguous(ds=24), 128, "cuda cores"),
    "chunk 40": (lambda: _contiguous(l=240), 40, "cuda cores"),
    "chunk 24": (lambda: _contiguous(l=240), 24, "cuda cores"),
    "dh 144": (lambda: _contiguous(dh=144), 64, "cuda cores"),
    "dh = ds = 128 at chunk 128 (shared memory)": (lambda: _contiguous(dh=128, ds=128), 128,
                                                   "cuda cores"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_b5_route(case):
    make, chunk, route = ROUTE_CASES[case]
    assert ssd.b5_route(*make(), chunk) == route


def _source_layout_bytes(chunk, dh, ds):
    """tc::Layout's regions as the source writes them, evaluated here."""
    text = source("ssd_scan").read_text()
    body = text[text.index("struct Layout {", text.index("namespace tc {")):]
    body = body[: body.index("total = at;")]
    names = {"chunk": chunk, "dh": dh, "ds": ds, "ldx": dh + 8, "ldb": ds + 8, "ldh": dh + 8,
             "nrt": chunk // 16}
    regions = re.findall(r"take\(at, ([^;]+)\);", body)
    assert len(regions) == 16
    return sum(-(-eval(expr, {}, names) // 16) * 16 for expr in regions)


@pytest.mark.parametrize("chunk,dh,ds", [(128, 64, 64), (32, 16, 16), (64, 128, 128),
                                         (256, 64, 64), (48, 32, 48), (128, 128, 128)])
def test_tc_shared_bytes_is_the_source_layout(chunk, dh, ds):
    assert ssd.tc_shared_bytes(chunk, dh, ds) == _source_layout_bytes(chunk, dh, ds)


def test_tc_shared_bytes_at_the_slice_fits_two_blocks_an_sm():
    """The serving slice's block: 104,704 bytes, within the 232,448 a block
    may use, and two blocks fit an SM (the CUDA-core kernel's 184 KB fit
    one)."""
    need = ssd.tc_shared_bytes(128, 64, 64)
    assert need == 104_704 <= BLOCK_SHARED_BYTES
    assert 2 * (need + 1024) <= SM_SHARED_BYTES < 3 * (need + 1024)
    assert ssd.shared_bytes(128, 64, 64) + 1024 > SM_SHARED_BYTES / 2


@pytest.mark.parametrize("chunk", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dh,ds", [(16, 16), (64, 64), (128, 64), (64, 128), (128, 128)])
def test_route_takes_exactly_the_layouts_that_fit(chunk, dh, ds):
    args = _contiguous(b=1, h=1, l=256, dh=dh, ds=ds)
    fits = ssd.tc_shared_bytes(chunk, dh, ds) <= BLOCK_SHARED_BYTES
    assert ssd.b5_route(*args, chunk) == ("tensor cores" if fits else "cuda cores")


def test_cpu_tensors_run_the_plain_version_on_either_route():
    args = _t(*ssd_inputs(7, l=64, dh=32, ds=16), dtype=None)
    x, dt, A, B, C = args
    x, B, C = x.bfloat16(), B.bfloat16(), C.bfloat16()
    before = ssd.launches
    plain = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=32)
    for forced in (False, True):
        assert torch.equal(ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=32, _cuda_cores=forced), plain)
    assert ssd.launches == before


# --------------------------------------------------------------------------
# the mirror of the kernel's arithmetic
# --------------------------------------------------------------------------


def _direct_decay(dt, A, chunk):
    """exp(seg_ij)·dt_j with seg summed directly down each column, as the
    plain chunked version does, in dt's dtype."""
    b, h, l = dt.shape
    la = (dt * A[None, :, None]).reshape(b, h, l // chunk, chunk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    seg = torch.cumsum(torch.where(torch.tril(tri, -1), la[..., :, None], 0.0), dim=-2)
    return torch.exp(seg) * tri * dt.reshape(b, h, l // chunk, chunk)[..., None, :]


def _cum_difference_decay(dt, A, chunk):
    """The reference's exp(cum_i − cum_j)·dt_j."""
    b, h, l = dt.shape
    la = (dt * A[None, :, None]).reshape(b, h, l // chunk, chunk)
    cum = torch.cumsum(la, dim=-1)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    diff = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
    return torch.exp(diff) * tri * dt.reshape(b, h, l // chunk, chunk)[..., None, :]


@pytest.mark.parametrize("dt_scale", [1.0, 8.0])
@pytest.mark.parametrize("chunk", [64, 128])
def test_blocked_decays_match_float64(dt_scale, chunk):
    """zamba2-like decays (A = −1 … −16; the cumulative sums reach −800 and
    −7,000 within a chunk): the blocked sums lie as close to float64 as the
    direct column sums (each decay ≤ 2 × their relative error) and far
    closer than the reference's cum_i − cum_j; erow, coef and the chunk's
    total decay match float64 too."""
    _, dt, _, _, _ = ssd_inputs(20, b=2, h=4, l=256, dt_scale=dt_scale)
    dt = torch.from_numpy(dt)
    A = -torch.linspace(1.0, 16.0, 4)
    ours = ssd_tc_decays(dt, A, chunk=chunk)
    exact = ssd_tc_decays(dt.double(), A.double(), chunk=chunk)
    ref = _direct_decay(dt.double(), A.double(), chunk)
    torch.testing.assert_close(exact["decay"], ref, rtol=1e-12, atol=1e-300)
    live = ref > 1e-30

    def rel(v):
        return float(((v.double() - ref).abs() / ref.clamp_min(1e-300))[live].max())

    blocked, direct = rel(ours["decay"]), rel(_direct_decay(dt, A, chunk))
    assert blocked <= 2 * direct, (blocked, direct)
    assert rel(_cum_difference_decay(dt, A, chunk)) >= 5 * blocked
    for key in ("erow", "coef", "total"):
        torch.testing.assert_close(ours[key].double(), exact[key], rtol=3e-5, atol=1e-30)


def test_decays_vanish_above_the_diagonal_and_are_dt_on_it():
    _, dt, A, _, _ = ssd_inputs(21, l=128)
    d = ssd_tc_decays(torch.from_numpy(dt), torch.from_numpy(A), chunk=64)["decay"]
    upper = torch.triu(torch.ones((64, 64), dtype=torch.bool), 1)
    assert bool((d[..., upper] == 0).all())
    torch.testing.assert_close(torch.diagonal(d, dim1=-2, dim2=-1),
                               torch.from_numpy(dt).reshape(2, 3, 2, 64), rtol=0, atol=0)


def test_split_keeps_sixteen_bits():
    """hi + lo carries v to 2⁻¹⁶ relative; bf16 alone only to 2⁻⁹."""
    v = torch.from_numpy(np.random.default_rng(22).standard_normal(4096).astype(np.float32))
    hi, lo = _split_bf16(v)
    assert hi.dtype == lo.dtype == torch.float32
    assert bool(((hi + lo - v).abs() <= 2.0**-16 * v.abs()).all())
    assert float(((hi - v).abs() / v.abs()).max()) > 2.0**-10


@pytest.mark.parametrize("chunk", [32, 64, 128])
def test_tc_mirror_matches_recurrence_and_pallas(chunk):
    args = ssd_inputs(1, l=256)
    ours = ssd_scan_tc_ref(*_t(*args), chunk=chunk).numpy()
    np.testing.assert_allclose(ours, ssd_scan_ref(*_f64(*_t(*args))).numpy(), **TOL)
    np.testing.assert_allclose(ours, np.asarray(ref_recurrence(*_j(*args))), **TOL)
    kernel = ssd_scan_pallas(*_j(*args), chunk=chunk, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(kernel), **TOL)


def test_tc_mirror_dtype_bf16():
    x, dt, A, B, C = ssd_inputs(2, l=128, dh=32, ds=16)
    xb, Bb, Cb = _t(x, B, C, dtype=torch.bfloat16)
    ours = ssd_scan_tc_ref(xb, *_t(dt, A), Bb, Cb, chunk=64)
    assert ours.dtype == torch.bfloat16
    exact = ssd_scan_ref(*_f64(xb, *_t(dt, A), Bb, Cb))
    np.testing.assert_allclose(ours.float().numpy(), exact.numpy(), **BF16_TOL)
    kernel = ssd_scan_pallas(*[jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (xb,)],
                             *_j(dt, A), *[jnp.asarray(t.float().numpy()) for t in (Bb, Cb)],
                             chunk=64, interpret=True)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(kernel.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("b,h,l,dh,ds", [(1, 1, 64, 8, 4), (2, 4, 192, 32, 16), (1, 2, 128, 64, 64)])
def test_tc_mirror_shape_sweep(b, h, l, dh, ds):
    args = ssd_inputs(3, b, h, l, dh, ds)
    ours = ssd_scan_tc_ref(*_t(*args), chunk=64).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref_recurrence(*_j(*args))), **SWEEP_TOL)
    kernel = ssd_scan_pallas(*_j(*args), chunk=64, interpret=True)
    np.testing.assert_allclose(ours, np.asarray(kernel), **SWEEP_TOL)


def test_tc_mirror_is_the_chunked_arithmetic_before_rounding():
    """On bf16-valued inputs, in f32: the mirror and the plain chunked
    version differ only by the hi / lo splits and the summation order."""
    x, dt, A, B, C = _t(*ssd_inputs(4, l=256, dh=32, ds=16))
    x, B, C = (t.bfloat16().float() for t in (x, B, C))
    ours = ssd_scan_tc_ref(x, dt, A, B, C, chunk=64)
    plain = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=64)
    scale = float(plain.abs().max())
    assert float((ours - plain).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("dt_scale", [1.0, 8.0])
def test_tc_mirror_at_the_slice_widths_is_as_close_to_f64_as_the_plain(dt_scale):
    """bf16 at the slice's widths (dh = ds = 64, chunk 128, l = 512; 8 of
    its 112 heads) with zamba2's decay rates: no further from the float64
    recurrence than 2 × the plain chunked version (the card gate of
    chip_smoke.py phase ssd_kernel)."""
    x, dt, _, B, C = ssd_inputs(5, b=1, h=8, l=512, dh=64, ds=64, dt_scale=dt_scale)
    xb, Bb, Cb = _t(x, B, C, dtype=torch.bfloat16)
    dt, A = torch.from_numpy(dt), -torch.linspace(1.0, 16.0, 8)
    exact = ssd_scan_ref(*_f64(xb, dt, A, Bb, Cb))
    ours = ssd_scan_tc_ref(xb, dt, A, Bb, Cb, chunk=128)
    plain = ssd_scan_chunked_ref(xb, dt, A, Bb, Cb, chunk=128)
    ours_err = float((ours.double() - exact).abs().max())
    plain_err = float((plain.double() - exact).abs().max())
    assert ours_err <= 2 * plain_err, (ours_err, plain_err)
    np.testing.assert_allclose(ours.float().numpy(), plain.float().numpy(), **BF16_TOL)

"""The f32 tensor-core routes of the port's B4 (flash attention) and B5 (the
SSD scan), on the CPU.

The CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).  What the CPU can hold:

* TF32 rounding as ``cvt.rna.tf32.f32`` does it (``kernels.tf32``);
* the plain-torch mirrors of the two routes' arithmetic — 3xTF32 products
  of TF32 halves in the kernels' tiles and partials
  (``gqa_attention_tf32_mirror``, ``ssd_scan_tf32_mirror``) — against the
  reference's Pallas kernels in interpret mode and against float64, at the
  reference's tolerances (tests/test_flash_ssd_pallas.py:27,73: 2e-4 for
  B4, 2e-3 for B5), and the same mirrors in one-pass TF32 outside them;
* the route rules, ``flash_attention.b4_route`` and ``ssd_scan.b5_route``
  (the mirrors of the entry points' ``tf::takes``): every model's f32
  shape on the model's views takes the route, unaligned views do not;
* B5's layout, ``tf32_shared_bytes``, against the source's;
* CPU tensors run the plain versions and launch nothing.

Inputs are made from a seed with numpy and go through both packages.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_pallas
from repro_torch.kernels.build import source
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ref import gqa_attention_plain, gqa_attention_tf32_mirror
from repro_torch.kernels.ssd_scan import ssd_scan as ssd
from repro_torch.kernels.ssd_scan.ref import (
    ssd_scan_chunked_ref,
    ssd_scan_ref,
    ssd_scan_tf32_mirror,
)
from repro_torch.kernels.tf32 import tf32_matmul, tf32_round, tf32_split


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


B4_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_flash_ssd_pallas.py:27
B5_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_flash_ssd_pallas.py:73
BLOCK_SHARED_BYTES = 232_448


def _close(a, b, tol) -> bool:
    return torch.allclose(torch.as_tensor(np.asarray(a)).double(),
                          torch.as_tensor(np.asarray(b)).double(), **tol)


# --------------------------------------------------------------------------
# TF32 rounding
# --------------------------------------------------------------------------


def test_tf32_round_is_cvt_rna():
    """To nearest with ties away from zero, 13 low bits cleared: 1 + 2⁻¹¹
    (half a TF32 step) goes up, −(1 + 2⁻¹¹) down, 1 + 2⁻¹² stays at 1."""
    x = torch.tensor([1.0, 1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-12, 3.0,
                      float("inf"), -float("inf")])
    want = [1.0, 1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-10, 3.0, float("inf"), -float("inf")]
    assert tf32_round(x).tolist() == want
    assert torch.isnan(tf32_round(torch.tensor([float("nan")]))).all()


def test_tf32_round_keeps_ten_bits_and_the_halves_sum_back():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(10_000) * 10.0 ** rng.integers(-8, 8, 10_000))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all() and (lo.view(torch.int32) & 0x1FFF == 0).all()
    assert ((hi - x).abs() <= x.abs() * 2.0**-11).all()
    # hi + lo keeps 21 or more of x's 24 bits
    assert ((hi.double() + lo.double() - x.double()).abs() <= x.abs().double() * 2.0**-21).all()


def test_3xtf32_product_is_f32_accurate_and_one_pass_is_not():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 224)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((224, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    three = float((tf32_matmul(a, b).double() - exact).abs().max()) / scale
    one = float((tf32_matmul(a, b, passes=1).double() - exact).abs().max()) / scale
    assert three < 2e-6 < 1e-4 < one


# --------------------------------------------------------------------------
# B4: the mirror against the reference's Pallas kernel and float64
# --------------------------------------------------------------------------

#: (b, hq, hkv, sq, skv, dh, causal): dh 32 / 64 / 112 / 224, GQA groups of
#: 1, 2 and 4, causal and not, ragged lengths, whisper's 1,500 kv rows
B4_CASES = [
    (1, 4, 2, 128, 128, 32, True), (1, 4, 4, 96, 160, 32, False),
    (1, 8, 2, 64, 64, 64, True), (1, 4, 2, 128, 256, 64, False),
    (1, 4, 2, 200, 200, 112, True), (1, 2, 2, 77, 333, 112, False),
    (1, 2, 1, 96, 96, 224, True), (1, 2, 2, 77, 300, 224, False), (1, 2, 2, 63, 63, 224, True),
    (1, 2, 1, 40, 1500, 64, False), (1, 2, 2, 1, 1500, 64, False),
]


def _b4_inputs(seed, b, hq, hkv, sq, skv, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, dh), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, dh), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, dh), dtype=np.float32))


@pytest.mark.parametrize("case", B4_CASES, ids=lambda c: "-".join(map(str, c)))
def test_b4_mirror_matches_pallas_and_f64(case):
    b, hq, hkv, sq, skv, dh, causal = case
    q, k, v = _b4_inputs(sq * 7 + skv + dh, b, hq, hkv, sq, skv, dh)
    pallas = np.array(ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=causal, bq=sq, bk=skv, interpret=True))
    mirror = gqa_attention_tf32_mirror(*map(torch.from_numpy, (q, k, v)), causal=causal)
    exact = gqa_attention_plain(*(torch.from_numpy(a).double() for a in (q, k, v)), causal=causal)
    assert mirror.dtype == torch.float32 and mirror.shape == (b, hq, sq, dh)
    torch.testing.assert_close(mirror, torch.from_numpy(pallas), **B4_TOL)
    torch.testing.assert_close(mirror.double(), exact, **B4_TOL)


def test_b4_mirror_of_a_fully_masked_row_is_zero():
    """Causal with more query rows than kv rows: every row sees column 0,
    so none is fully masked; an empty kv gives l = 0 and an output of 0."""
    q, k, v = (torch.from_numpy(a) for a in _b4_inputs(3, 1, 2, 2, 5, 0, 32))
    out = gqa_attention_tf32_mirror(q, k, v, causal=True)
    assert out.shape == (1, 2, 5, 32) and (out == 0).all()


def test_b4_one_pass_tf32_falls_outside_the_tolerance():
    """The same tiles with one-pass TF32 products miss 2e-4 against f64
    where 3xTF32 meets it: why both products are 3xTF32."""
    missed = []
    for case in B4_CASES[:9]:
        b, hq, hkv, sq, skv, dh, causal = case
        q, k, v = (torch.from_numpy(a) for a in _b4_inputs(dh + sq, b, hq, hkv, sq, skv, dh))
        exact = gqa_attention_plain(q.double(), k.double(), v.double(), causal=causal)
        three = gqa_attention_tf32_mirror(q, k, v, causal=causal)
        one = gqa_attention_tf32_mirror(q, k, v, causal=causal, passes=1)
        assert _close(three, exact, B4_TOL), case
        missed.append(not _close(one, exact, B4_TOL))
    assert any(missed), missed


# --------------------------------------------------------------------------
# B5: the mirror against the reference's Pallas kernel and float64
# --------------------------------------------------------------------------


def _softplus(x):
    return np.logaddexp(x, 0.0)


def _b5_inputs(seed, b, h, l, dh, ds):
    """The reference test's recipe (tests/test_flash_ssd_pallas.py:59)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, l, dh)).astype(np.float32)
    dt = _softplus(rng.standard_normal((b, h, l)) - 1.0).astype(np.float32)
    A = (-_softplus(rng.standard_normal(h))).astype(np.float32)
    B = rng.standard_normal((b, l, ds)).astype(np.float32)
    C = rng.standard_normal((b, l, ds)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("ds", [16, 64, 128])
def test_b5_mirror_matches_pallas_and_f64(ds, chunk):
    dh = 32 if ds == 16 else 64
    args = _b5_inputs(ds + chunk, 1, 2, 256, dh, ds)
    pallas = np.array(ssd_scan_pallas(*map(jnp.asarray, args), chunk=chunk, interpret=True))
    targs = [torch.from_numpy(a) for a in args]
    mirror = ssd_scan_tf32_mirror(*targs, chunk=chunk)
    exact = ssd_scan_ref(*(t.double() for t in targs))
    assert mirror.dtype == torch.float32 and mirror.shape == targs[0].shape
    torch.testing.assert_close(mirror, torch.from_numpy(pallas), **B5_TOL)
    torch.testing.assert_close(mirror.double(), exact, **B5_TOL)
    # as close to f64 as the plain chunked version, give or take f32 noise
    plain = ssd_scan_chunked_ref(*targs, chunk=chunk)
    ours, theirs = ((t.double() - exact).abs().max().item() for t in (mirror, plain))
    assert ours <= 2 * theirs + 1e-5, (ours, theirs)


def test_b5_one_pass_tf32_falls_outside_the_tolerance():
    missed = []
    for ds, chunk in ((16, 16), (64, 64), (128, 128)):
        targs = [torch.from_numpy(a) for a in _b5_inputs(ds, 1, 2, 256, 64, ds)]
        exact = ssd_scan_ref(*(t.double() for t in targs))
        assert _close(ssd_scan_tf32_mirror(*targs, chunk=chunk), exact, B5_TOL)
        missed.append(not _close(ssd_scan_tf32_mirror(*targs, chunk=chunk, passes=1), exact, B5_TOL))
    assert any(missed), missed


# --------------------------------------------------------------------------
# the route rules
# --------------------------------------------------------------------------

#: B4 at every model's f32 head shape (the reduced presets' too): (hq, hkv, dh)
MODEL_ATTN = {"zamba2-7b shared block": (32, 32, 224), "llama3.2-1b": (32, 8, 64),
              "qwen1.5-110b": (64, 8, 128), "command-r-plus-104b": (96, 8, 128),
              "whisper-large-v3": (20, 20, 64), "cpu-small presets": (4, 2, 32)}


def _attn_views(hq, hkv, dh, b=2, sq=40, skv=40, dtype=torch.float32):
    """q, k, v as the model passes them: (b, s, h, dh) projections viewed
    (b, h, s, dh)."""
    return (torch.zeros((b, sq, hq, dh), dtype=dtype).transpose(1, 2),
            torch.zeros((b, skv, hkv, dh), dtype=dtype).transpose(1, 2),
            torch.zeros((b, skv, hkv, dh), dtype=dtype).transpose(1, 2))


def _attn_unaligned(dh=64):
    buf = torch.zeros((3, 2, 40, 4, dh + 3))
    return tuple(buf[i, :, :, :, 1 : 1 + dh].transpose(1, 2) for i in range(3))


B4_ROUTES = {
    **{f"{name} f32": (lambda s=shape: _attn_views(*s), "tf32 tensor cores")
       for name, shape in MODEL_ATTN.items()},
    "whisper's decode cross-attention f32": (lambda: _attn_views(20, 20, 64, sq=1, skv=1500),
                                             "tf32 tensor cores"),
    "contiguous f32, dh 40": (lambda: tuple(torch.zeros((1, 2, 9, 40)) for _ in range(3)),
                              "tf32 tensor cores"),
    "zamba2 bf16": (lambda: _attn_views(32, 32, 224, dtype=torch.bfloat16), "tensor cores"),
    "rows one element into a wider buffer": (_attn_unaligned, "cuda cores"),
    "dh 36": (lambda: _attn_views(2, 2, 36), "cuda cores"),
    "bf16 dh 40": (lambda: _attn_views(2, 2, 40, dtype=torch.bfloat16), "cuda cores"),
}


@pytest.mark.parametrize("case", list(B4_ROUTES))
def test_b4_route(case):
    make, route = B4_ROUTES[case]
    assert fa.b4_route(*make()) == route


#: B5 at every model's f32 shape: (heads, dh, ds, chunk)
MODEL_SSD = {"zamba2-7b": (112, 64, 64, 128), "mamba2-370m": (32, 64, 128, 128),
             "cpu-small presets": (4, 32, 16, 16)}


def _ssd_views(h, dh, ds, b=2, l=256, dtype=torch.float32):
    """x, B, C as slices of one (b, l, h·dh + 2·ds) conv output (x viewed
    (b, h, l, dh)) and dt the (b, l, h) projection transposed, as the
    Mamba-2 block passes them."""
    di = h * dh
    xBC = torch.zeros((b, l, di + 2 * ds), dtype=dtype)
    x = xBC[..., :di].reshape(b, l, h, dh).transpose(1, 2)
    dt = torch.zeros((b, l, h)).transpose(1, 2)
    return x, dt, torch.zeros(h), xBC[..., di : di + ds], xBC[..., di + ds :]


def _ssd_unaligned():
    x, dt, A, _, _ = _ssd_views(3, 64, 64)
    wide = torch.zeros((2, 3, 256, 65))
    BC = torch.zeros((2, 256, 129))
    return wide[..., 1:], dt, A, BC[..., 1:65], BC[..., 65:]


B5_ROUTES = {
    **{f"{name} f32": (lambda s=shape: _ssd_views(*s[:3]), shape[3], "tf32 tensor cores")
       for name, shape in MODEL_SSD.items()},
    "zamba2-7b bf16": (lambda: _ssd_views(112, 64, 64, dtype=torch.bfloat16), 128,
                       "tensor cores"),
    "f32 rows one element into a wider buffer": (_ssd_unaligned, 128, "cuda cores"),
    "f32 dh 40": (lambda: _ssd_views(2, 40, 64), 128, "cuda cores"),
    "f32 chunk 8": (lambda: _ssd_views(2, 32, 16), 8, "cuda cores"),
    "f32 chunk 256 (shared memory)": (lambda: _ssd_views(2, 64, 64), 256, "cuda cores"),
    "f32 dh = ds = 128 at chunk 128 (shared memory)": (lambda: _ssd_views(2, 128, 128), 128,
                                                       "cuda cores"),
}


@pytest.mark.parametrize("case", list(B5_ROUTES))
def test_b5_route(case):
    make, chunk, route = B5_ROUTES[case]
    assert ssd.b5_route(*make(), chunk) == route


def _python(expr):
    """A C conditional chain ``a ? b : c ? d : e`` as Python."""
    if "?" not in expr:
        return expr
    cond, rest = expr.split("?", 1)
    then, other = rest.split(":", 1)
    return f"({then}) if ({cond}) else ({_python(other)})"


def _source_layout_bytes(chunk, dh, ds):
    """tf::Layout's regions as the source writes them, evaluated here (the
    padded widths by the source's own rule, read from it too)."""
    text = source("ssd_scan").read_text()
    body = text[text.index("namespace tf {"):]
    rules = dict(re.findall(r"inline int (padded_d[hs])\(int d[hs]\) \{ return ([^;]+); \}", body))
    assert set(rules) == {"padded_dh", "padded_ds"}
    names = {"chunk": chunk, "dh": dh, "ds": ds, "nrt": chunk // 16}
    names["padded_dh"] = lambda v: eval(_python(rules["padded_dh"]), {}, {"dh": v})
    names["padded_ds"] = lambda v: eval(_python(rules["padded_ds"]), {}, {"ds": v})
    body = body[body.index("struct Layout {"):]
    body = body[: body.index("total = at;")]
    for name, expr in re.findall(r"(ldx|ldb|ldh) = ([^;]+);", body):
        names[name] = eval(expr, {}, names)
    regions = re.findall(r"take\(at, ([^;]+)\);", body)
    assert len(regions) == 14
    return sum(-(-eval(expr, {}, names) // 16) * 16 for expr in regions)


@pytest.mark.parametrize("chunk,dh,ds", [(128, 64, 64), (128, 64, 128), (16, 32, 16),
                                         (64, 128, 128), (256, 64, 64), (48, 32, 48)])
def test_tf32_shared_bytes_is_the_source_layout(chunk, dh, ds):
    assert ssd.tf32_shared_bytes(chunk, dh, ds) == _source_layout_bytes(chunk, dh, ds)


def test_tf32_layout_takes_mamba2_whole():
    """mamba2-370m's f32 chunk (ds = 128, dh = 64, 128 steps) fits one
    block whole: 219,392 bytes, where the CUDA-core route's whole-state
    layout needs 266,752 and is cut into three state slices."""
    assert ssd.tf32_shared_bytes(128, 64, 128) == 219_392 <= BLOCK_SHARED_BYTES
    assert ssd.shared_bytes(128, 64, 128) == 266_752 > BLOCK_SHARED_BYTES
    assert ssd.tf32_shared_bytes(256, 64, 64) > BLOCK_SHARED_BYTES


# --------------------------------------------------------------------------
# CPU tensors
# --------------------------------------------------------------------------


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    q, k, v = (torch.from_numpy(a) for a in _b4_inputs(5, 1, 4, 2, 48, 48, 64))
    assert fa.b4_route(q, k, v) == "tf32 tensor cores"
    before = fa.launches
    plain = gqa_attention_plain(q, k, v, causal=True)
    assert torch.equal(fa.flash_attention_cuda(q, k, v, causal=True), plain)
    assert fa.launches == before

    args = [torch.from_numpy(a) for a in _b5_inputs(6, 1, 2, 64, 32, 16)]
    assert ssd.b5_route(*args, 16) == "tf32 tensor cores"
    before = ssd.launches
    plain = ssd_scan_chunked_ref(*args, chunk=16)
    for forced in (False, True):
        assert torch.equal(ssd.ssd_scan_cuda(*args, chunk=16, _cuda_cores=forced), plain)
    assert ssd.launches == before

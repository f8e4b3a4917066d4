"""The port's flash attention (B4) against the reference's.

Inputs are made from a seed with numpy and go through both packages: the
reference's Pallas kernel in interpret mode (``flash_attention(...,
interpret=True)``) and its oracle ``gqa_attention_ref``, the port's wrapper
on CPU tensors (which runs the plain PyTorch version).  The cases are those
of tests/test_flash_ssd_pallas.py:14-56 with its tolerances: 2e-4 in f32,
3e-2 in bf16.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` (which imports no JAX) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import gqa_attention_ref
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import (
    attention_plain,
    flash_attention_cuda,
    gqa_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import flash_attention

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _qkv(seed, b, hq, hkv, sq, skv, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    return flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw).numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv,dh", [(128, 128, 64), (256, 384, 32)])
def test_matches_reference_kernel_and_oracle(causal, sq, skv, dh):
    q, k, v = _qkv(sq + skv + dh, 2, 4, 4, sq, skv, dh)
    ours = _port(q, k, v, causal=causal)
    kernel = np.asarray(ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=causal, interpret=True))
    oracle = np.asarray(gqa_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal))
    np.testing.assert_allclose(ours, kernel, **TOL)
    np.testing.assert_allclose(ours, oracle, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_computes_in_f64_for_f64_inputs(causal):
    """f64 inputs stay f64 (the witness chip_smoke.py holds B4 to): the
    plain version matches a numpy f64 softmax attention to 1e-12."""
    q, k, v = (a.astype(np.float64) for a in _qkv(7, 1, 4, 2, 40, 56, 24))
    kk, vv = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    s = np.einsum("bhqd,bhkd->bhqk", q, kk) / np.sqrt(24)
    if causal:
        s = np.where(np.arange(40)[:, None] >= np.arange(56)[None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), vv)
    ours = gqa_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-12, atol=1e-12)


def test_gqa_grouping():
    """8 q heads on 2 kv heads: q head h reads kv head h // 4."""
    q, k, v = _qkv(1, 1, 8, 2, 128, 128, 32)
    ours = _port(q, k, v, causal=True)
    kernel = np.asarray(ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=True, interpret=True))
    np.testing.assert_allclose(ours, kernel, **TOL)
    # each group equals plain attention against its own kv head
    for h in range(8):
        one = attention_plain(torch.from_numpy(q[:, h]), torch.from_numpy(k[:, h // 4]),
                              torch.from_numpy(v[:, h // 4]), causal=True).numpy()
        np.testing.assert_allclose(ours[:, h], one, rtol=1e-6, atol=1e-6)


def test_bf16():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 2, 128, 64)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kernel = ref_flash_attention(xb, xb, xb, causal=True, interpret=True)
    oracle = gqa_attention_ref(xb, xb, xb, causal=True)
    t = torch.from_numpy(x).to(torch.bfloat16)
    ours = flash_attention(t, t, t, causal=True)
    assert ours.dtype == torch.bfloat16
    ours = ours.float().numpy()
    np.testing.assert_allclose(ours, np.asarray(kernel.astype(jnp.float32)), **BF16_TOL)
    np.testing.assert_allclose(ours, np.asarray(oracle.astype(jnp.float32)), **BF16_TOL)


@pytest.mark.parametrize("sq,skv,causal", [(200, 200, True), (77, 300, False), (1, 9, False)])
def test_any_length(sq, skv, causal):
    """The port takes any sq / skv (the reference's multiple-of-128 assert
    is a Pallas block artifact): held to the reference's oracle."""
    q, k, v = _qkv(sq * skv, 2, 4, 2, sq, skv, 48)
    ours = _port(q, k, v, causal=causal)
    oracle = np.asarray(gqa_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal))
    np.testing.assert_allclose(ours, oracle, **TOL)


@pytest.mark.parametrize("dh", [32, 64, 112, 224])
def test_head_dims_of_the_port(dh):
    """The head dims the port's kernel is built for, the slice's 224 among
    them (the shared block at width 2·d), against the reference's kernel."""
    q, k, v = _qkv(dh, 1, 2, 2, 128, 128, dh)
    ours = _port(q, k, v, causal=True)
    kernel = np.asarray(ref_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=True, interpret=True))
    np.testing.assert_allclose(ours, kernel, **TOL)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 64, 64, 32))
    before = fa_mod.launches
    ours = flash_attention_cuda(q, k, v, causal=True)
    assert fa_mod.launches == before
    assert torch.equal(ours, gqa_attention_plain(q, k, v, causal=True))


def test_transposed_views_are_taken_as_they_are():
    """The model hands over (B, S, H, hd) storage as (B, H, S, hd) views."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 4, 4, 32, 32, 16))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(flash_attention(*views), flash_attention(q, k, v), rtol=0, atol=0)


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """The meta device is neither CPU nor CUDA: the wrapper must raise."""
    q = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, q, q)


def test_heads_must_group():
    q = torch.zeros((1, 3, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, k, k)


def test_bf16_split_of_p_keeps_pv_in_f32():
    """The bf16 kernel's P·V, emulated on the CPU: P (f32 softmax weights)
    split into P_hi = bf16(P) and P_lo = bf16(P − P_hi), each times bf16 V
    with f32 sums, stays within 1e-5 (of the largest output) of the f32
    product; P_hi alone (P rounded to bf16) does not."""
    rng = np.random.default_rng(14)
    s = 3.0 * torch.from_numpy(rng.standard_normal((64, 512)).astype(np.float32))
    p = torch.softmax(s, dim=-1)
    v = torch.from_numpy(rng.standard_normal((512, 224)).astype(np.float32)).bfloat16().float()
    p_hi = p.bfloat16().float()
    p_lo = (p - p_hi).bfloat16().float()
    f32 = p @ v
    scale = f32.abs().max()
    assert (p_hi @ v + p_lo @ v - f32).abs().max() <= 1e-5 * scale
    assert (p_hi @ v - f32).abs().max() > 1e-5 * scale

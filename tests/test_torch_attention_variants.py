"""The port's chunked attention, cross-attention and MLA against the
reference's (mirrors tests/test_attention_variants.py).

Parameters are the reference's own init (``jax.random.PRNGKey``), carried
over by ``lm_params_from_jax``; inputs are made from a seed with numpy;
f32 on the CPU.  Tolerances: the reference test's own (chunked vs SDPA
2e-4, the config toggles 3e-4, chunked gradients 2e-3); one attention
layer against the reference 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro_torch import lm_params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.models import attention


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CHUNK_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_attention_variants.py:26
TOGGLE_TOL = dict(rtol=3e-4, atol=3e-4)  # :44, :57
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)  # :39
REF_TOL = dict(rtol=1e-4, atol=1e-4)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunk", [(64, 16), (128, 32), (96, 32)])
def test_sdpa_chunked_matches_the_reference_and_sdpa(causal, S, chunk):
    B, H, KV, hd = 2, 8, 2, 16
    q, k, v = _x(0, B, S, H, hd), _x(1, B, S, KV, hd), _x(2, B, S, KV, hd)
    ref = ref_attn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                 q_chunk=chunk, kv_chunk=chunk)
    before = fa_mod.launches
    ours = attention._sdpa_chunked(_t(q), _t(k), _t(v), causal=causal, q_chunk=chunk,
                                   kv_chunk=chunk)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **CHUNK_TOL)
    full = attention._sdpa(_t(q), _t(k), _t(v), causal=causal, use_kernel=False)
    np.testing.assert_allclose(ours.numpy(), full.numpy(), **CHUNK_TOL)
    assert fa_mod.launches == before  # the plain loop on CPU tensors


def test_sdpa_chunked_gradients_match_the_unchunked():
    B, S, H, KV, hd = 1, 64, 4, 2, 8
    k, v = _t(_x(4, B, S, KV, hd)), _t(_x(5, B, S, KV, hd))
    grads = []
    for chunked in (False, True):
        q = _t(_x(3, B, S, H, hd)).requires_grad_(True)
        out = (attention._sdpa_chunked(q, k, v, causal=True, q_chunk=16, kv_chunk=16) if chunked
               else attention._sdpa(q, k, v, causal=True, use_kernel=False))
        (out**2).sum().backward()
        grads.append(q.grad)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), **GRAD_TOL)


def _layer(arch, init, seed, **overrides):
    rcfg = ref_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    rp = init(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    return rcfg, cfg, rp, lm_params_from_jax(rp, device="cpu")


def test_chunked_gqa_config_toggle():
    rcfg, cfg, rp, p = _layer("llama3.2-1b", ref_attn.gqa_init, 0)
    x = _x(6, 2, 32, cfg.d_model)
    ccfg = dataclasses.replace(cfg, chunked_attention=True, attn_chunk=8)
    ours = attention.gqa_full(p, ccfg, _t(x))
    np.testing.assert_allclose(ours.numpy(), attention.gqa_full(p, cfg, _t(x)).numpy(), **TOGGLE_TOL)
    ref = ref_attn.gqa_full(rp, dataclasses.replace(rcfg, chunked_attention=True, attn_chunk=8),
                            jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **REF_TOL)


@pytest.mark.parametrize("q_lora", [True, False])
def test_chunked_mla_config_toggle_and_gradients(q_lora):
    over = {} if q_lora else {"q_lora_rank": 0}
    rcfg, cfg, rp, p = _layer("minicpm3-4b", ref_attn.mla_init, 2, **over)
    assert ("w_dq" in p) == q_lora
    x = _x(7, 2, 32, cfg.d_model)
    ccfg = dataclasses.replace(cfg, chunked_attention=True, attn_chunk=8)
    ours = attention.mla_full(p, ccfg, _t(x))
    np.testing.assert_allclose(ours.numpy(), attention.mla_full(p, cfg, _t(x)).numpy(), **TOGGLE_TOL)
    ref = ref_attn.mla_full(rp, dataclasses.replace(rcfg, chunked_attention=True, attn_chunk=8),
                            jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **REF_TOL)

    grads = []
    for c in (cfg, ccfg):
        xt = _t(x[:1, :16]).requires_grad_(True)
        (attention.mla_full(p, c, xt) ** 2).sum().backward()
        grads.append(xt.grad)
    assert bool(torch.isfinite(grads[1]).all())
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), **GRAD_TOL)


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_full_prefill_decode_match_the_reference(q_lora):
    over = {} if q_lora else {"q_lora_rank": 0}
    rcfg, cfg, rp, p = _layer("deepseek-v2-236b", ref_attn.mla_init, 3, **over)
    B, S, T = 2, 12, 20
    x = _x(8, B, S, cfg.d_model)
    for causal in (True, False):
        ref = ref_attn.mla_full(rp, rcfg, jnp.asarray(x), causal=causal)
        ours = attention.mla_full(p, cfg, _t(x), causal=causal)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **REF_TOL)

    rout, rcache = ref_attn.mla_prefill(rp, rcfg, jnp.asarray(x[:, :8]), T)
    out, cache = attention.mla_prefill(p, cfg, _t(x[:, :8]), T)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **REF_TOL)
    assert cache.keys() == rcache.keys()
    for k in cache:
        assert tuple(cache[k].shape) == rcache[k].shape == (B, T, cache[k].shape[-1])
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]), **REF_TOL)
    ref_decode = jax.jit(lambda p, x, c, pos: ref_attn.mla_decode(p, rcfg, x, c, pos))
    for t in range(8, S):  # decode the rest from the prefill's cache
        pos = np.full((B,), t, np.int32)
        rout, rcache = ref_decode(rp, jnp.asarray(x[:, t : t + 1]), rcache, jnp.asarray(pos))
        out, cache = attention.mla_decode(p, cfg, _t(x[:, t : t + 1]), cache,
                                          torch.from_numpy(pos.astype(np.int64)))
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **REF_TOL)
    for k in cache:
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]), **REF_TOL)


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_gqa_cross_with_and_without_the_encoder_cache(qkv_bias):
    rcfg, cfg, rp, p = _layer("whisper-large-v3", ref_attn.gqa_cross_init, 4, qkv_bias=qkv_bias)
    if qkv_bias:  # the reference inits the biases to 0: make them count
        for name in ("bq", "bk", "bv"):
            rp[name] = jnp.asarray(_x(20 + len(name), *rp[name].shape))
        p = lm_params_from_jax(rp, device="cpu")
    x, enc = _x(9, 2, 5, cfg.d_model), _x(10, 2, 16, cfg.d_model)
    rout, rkv = ref_attn.gqa_cross(rp, rcfg, jnp.asarray(x), jnp.asarray(enc))
    before = fa_mod.launches
    out, kv = attention.gqa_cross(p, cfg, _t(x), _t(enc))
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **REF_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(kv[k].numpy(), np.asarray(rkv[k]), **REF_TOL)
    # decode: one query against the cached projections
    rout1, _ = ref_attn.gqa_cross(rp, rcfg, jnp.asarray(x[:, :1]), None, enc_cache=rkv)
    out1, kv1 = attention.gqa_cross(p, cfg, _t(x[:, :1]), None, enc_cache=kv)
    np.testing.assert_allclose(out1.numpy(), np.asarray(rout1), **REF_TOL)
    assert kv1["k"] is kv["k"]
    plain, _ = attention.gqa_cross(p, cfg, _t(x), _t(enc), use_kernel=False)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **REF_TOL)
    assert fa_mod.launches == before

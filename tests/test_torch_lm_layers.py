"""The port's LM layers, GQA attention and Mamba-2 block against the
reference's, with the reference's parameters carried over by
``lm_params_from_jax``.

Inputs are made from a seed with numpy; parameters are the reference's own
init (``jax.random.PRNGKey``), converted.  Everything is f32 on the CPU, so
the tolerances are f32 rounding: 1e-5 for one layer, 1e-4 for a block.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import ssm as ref_ssm
from repro.models.hybrid import _attn_cfg as ref_attn_cfg
from repro_torch import lm_params_from_jax
from repro_torch.configs import ALL_ARCHS, get_config, list_configs
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
from repro_torch.models import attention, layers, ssm
from repro_torch.models.hybrid import _attn_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def cfgs():
    return ref_get_config("zamba2-7b").reduced(), get_config("zamba2-7b").reduced()


def _x(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _convert(params):
    return lm_params_from_jax(params, device="cpu")


def test_config_registry():
    """Every architecture of the reference's zoo is registered, field for
    field; an unknown name raises KeyError."""
    assert list_configs() == sorted(ALL_ARCHS) == sorted(REF_ARCHS)
    for name in ALL_ARCHS:
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(ref_get_config(name))
    with pytest.raises(KeyError):
        get_config("no-such-model")


def test_norms_rope_mlp_embed(cfgs):
    rcfg, cfg = cfgs
    x = _x(0, 2, 5, 64)
    scale = _x(1, 64) + 1.0
    ours = layers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    ref = ref_layers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LAYER_TOL)
    bias = _x(2, 64)
    ours = layers.layernorm({"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
                            torch.from_numpy(x))
    ref = ref_layers.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                               jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **LAYER_TOL)

    q = _x(3, 2, 7, 4, 32, scale=3.0)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 1000]])
    ours = layers.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), 10000.0)
    ref = ref_layers.apply_rope(jnp.asarray(q), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)

    for act in ("swiglu", "gelu"):
        c = dataclasses.replace(rcfg, activation=act)
        p = ref_layers.mlp_init(jax.random.PRNGKey(4), 64, 96, c, jnp.float32)
        if act == "gelu":
            p = {**p, "b_in": jnp.asarray(_x(5, 96)), "b_out": jnp.asarray(_x(6, 64))}
        ours = layers.mlp_apply(_convert(p), torch.from_numpy(x), dataclasses.replace(cfg, activation=act))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref_layers.mlp_apply(p, jnp.asarray(x), c)),
                                   **LAYER_TOL)

    table = ref_layers.embedding_init(jax.random.PRNGKey(7), 50, 16, jnp.float32)
    tok = np.array([[0, 49, 3], [7, 7, 1]])
    ours = layers.embed(_convert(table), torch.from_numpy(tok))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref_layers.embed(table, jnp.asarray(tok))))


def test_normal_init_draws_f32_then_casts():
    gen = torch.Generator().manual_seed(0)
    a = layers.normal_init(gen, (64, 32), 0.5, torch.bfloat16)
    gen.manual_seed(0)
    b = layers.normal_init(gen, (64, 32), 0.5, torch.float32)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, b.to(torch.bfloat16))


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_gqa_full_prefill_decode(cfgs, kv_heads):
    """The shared block's attention (width 2·d, head dim 64 here), with the
    port's kernel path (the plain flash version on the CPU) and its plain
    path, against the reference's full, prefill and decode."""
    rcfg, cfg = (ref_attn_cfg(cfgs[0]), _attn_cfg(cfgs[1]))
    rcfg = dataclasses.replace(rcfg, num_kv_heads=kv_heads)
    cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    rp = ref_attn.gqa_init(jax.random.PRNGKey(11), rcfg, jnp.float32)
    p = _convert(rp)
    B, S = 2, 12
    x = _x(12, B, S, rcfg.d_model)
    ref = np.asarray(ref_attn.gqa_full(rp, rcfg, jnp.asarray(x), causal=True))
    for use_kernel in (True, False):
        ours = attention.gqa_full(p, cfg, torch.from_numpy(x), causal=True, use_kernel=use_kernel)
        np.testing.assert_allclose(ours.numpy(), ref, **BLOCK_TOL)
    ref_nc = np.asarray(ref_attn.gqa_full(rp, rcfg, jnp.asarray(x), causal=False))
    ours_nc = attention.gqa_full(p, cfg, torch.from_numpy(x), causal=False)
    np.testing.assert_allclose(ours_nc.numpy(), ref_nc, **BLOCK_TOL)

    rout, rcache = ref_attn.gqa_prefill(rp, rcfg, jnp.asarray(x[:, :8]), 16)
    out, cache = attention.gqa_prefill(p, cfg, torch.from_numpy(x[:, :8]), 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **BLOCK_TOL)
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == rcache[k].shape == (B, 16, kv_heads, rcfg.resolved_head_dim)
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]), **BLOCK_TOL)

    # decode the remaining 4 tokens against the prefilled cache; the rows
    # are at different lengths
    pos = np.array([8, 5])
    for t in range(4):
        xt = x[:, 8 + t : 9 + t]
        rout, rcache = ref_attn.gqa_decode(rp, rcfg, jnp.asarray(xt), rcache, jnp.asarray(pos + t))
        out, cache = attention.gqa_decode(p, cfg, torch.from_numpy(xt), cache,
                                          torch.from_numpy(pos + t))
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **BLOCK_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]), **BLOCK_TOL)


def test_masked_cache_update_leaves_the_callers_cache():
    cache = torch.zeros((2, 4, 1, 3))
    new = torch.ones((2, 1, 1, 3))
    out = attention._masked_cache_update(cache, new, torch.tensor([1, 3]))
    assert cache.abs().sum() == 0
    assert out[0, 1].eq(1).all() and out[1, 3].eq(1).all() and out.sum() == 6


@pytest.mark.parametrize("S", [16, 32])
def test_mamba2_full_prefill_decode(cfgs, S):
    """One Mamba-2 block: the full pass (kernel path and plain path), the
    prefill's terminal cache, and decode continuing from it."""
    rcfg, cfg = cfgs
    rp = ref_ssm.mamba2_init(jax.random.PRNGKey(21), rcfg, jnp.float32)
    # non-trivial dt_bias / D / conv_b so every term is exercised
    rp = {**rp, "dt_bias": jnp.asarray(_x(22, rcfg.ssm_heads, scale=0.5)),
          "D": jnp.asarray(_x(23, rcfg.ssm_heads)),
          "conv_b": jnp.asarray(_x(24, rp["conv_b"].shape[0], scale=0.1))}
    p = _convert(rp)
    B = 2
    x = _x(25, B, S + 4, rcfg.d_model)
    ref = np.asarray(ref_ssm.mamba2_full(rp, rcfg, jnp.asarray(x[:, :S])))
    for use_kernel in (True, False):
        ours = ssm.mamba2_full(p, cfg, torch.from_numpy(x[:, :S]), use_kernel=use_kernel)
        np.testing.assert_allclose(ours.numpy(), ref, **BLOCK_TOL)

    rout, rcache = ref_ssm.mamba2_prefill(rp, rcfg, jnp.asarray(x[:, :S]))
    out, cache = ssm.mamba2_prefill(p, cfg, torch.from_numpy(x[:, :S]))
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **BLOCK_TOL)
    for k in ("conv", "ssd"):
        assert cache[k].dtype == (torch.float32)
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]), **BLOCK_TOL)
    for t in range(4):
        xt = x[:, S + t : S + t + 1]
        pos = jnp.full((B,), S + t, jnp.int32)
        rout, rcache = ref_ssm.mamba2_decode(rp, rcfg, jnp.asarray(xt), rcache, pos)
        out, cache = ssm.mamba2_decode(p, cfg, torch.from_numpy(xt), cache,
                                       torch.full((B,), S + t))
        np.testing.assert_allclose(out.numpy(), np.asarray(rout), **BLOCK_TOL)
    np.testing.assert_allclose(cache["ssd"].numpy(), np.asarray(rcache["ssd"]), **BLOCK_TOL)

    # the decode cache from zero reproduces the full pass token by token
    init = ssm.mamba2_init_cache(cfg, B, torch.float32)
    rinit = ref_ssm.mamba2_init_cache(rcfg, B, jnp.float32)
    assert {k: tuple(v.shape) for k, v in init.items()} == {k: v.shape for k, v in rinit.items()}
    steps = []
    for t in range(S):
        o, init = ssm.mamba2_decode(p, cfg, torch.from_numpy(x[:, t : t + 1]), init,
                                    torch.full((B,), t))
        steps.append(o)
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(), ref, **BLOCK_TOL)


def test_kernel_paths_launch_nothing_on_the_cpu(cfgs):
    rcfg, cfg = cfgs
    p = _convert(ref_ssm.mamba2_init(jax.random.PRNGKey(31), rcfg, jnp.float32))
    before = (ssd_mod.launches, fa_mod.launches)
    ssm.mamba2_full(p, cfg, torch.from_numpy(_x(32, 1, 16, rcfg.d_model)))
    assert (ssd_mod.launches, fa_mod.launches) == before


def test_chunked_attention_is_not_ported(cfgs):
    """The name is from before ``_sdpa_chunked`` was ported: a chunked
    config's GQA forward now runs the online-softmax loop on CPU tensors
    and matches the reference's chunked forward."""
    rcfg = dataclasses.replace(ref_attn_cfg(cfgs[0]), chunked_attention=True, attn_chunk=4)
    cfg = dataclasses.replace(_attn_cfg(cfgs[1]), chunked_attention=True, attn_chunk=4)
    rp = ref_attn.gqa_init(jax.random.PRNGKey(33), rcfg, jnp.float32)
    x = _x(34, 1, 8, cfg.d_model)
    ref = ref_attn.gqa_full(rp, rcfg, jnp.asarray(x))
    before = fa_mod.launches
    ours = attention.gqa_full(_convert(rp), cfg, torch.from_numpy(x))
    assert fa_mod.launches == before
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **BLOCK_TOL)

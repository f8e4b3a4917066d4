"""The port's decoder-only transformer (dense, MoE, MLA) against the
reference's ``repro.models.transformer``, on reduced configs in f32:
llama3.2-1b (tied embeddings), qwen1.5-110b (QKV bias), command-r-plus-104b,
minicpm3-4b (MLA), granite-moe-1b-a400m (MoE) and deepseek-v2-236b (MLA,
MoE with a shared expert, a dense first layer).

Parameters are the reference's own init (``jax.random.PRNGKey``), carried
over by ``lm_params_from_jax`` (qwen's QKV biases, zero at init, are drawn
so that they count); tokens come from a seed with numpy.  Tolerances: the
forward logits and aux, the prefill's last logits and its cache, and three
decode steps from that cache against the reference's 1e-4; decode stepped
over a prompt against the forward at the reference's own bound, 2e-2
(tests/test_models_smoke.py:143-148), for the non-MoE models (an MoE
decode step routes its B tokens as one group, with its own capacity: the
reference's test leaves them out, :94); bf16 forwards at 5e-2 of the
largest logit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_transformer
from repro_torch import lm_params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.models import build_model, transformer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_REL = 5e-2
ARCHS = ("llama3.2-1b", "qwen1.5-110b", "command-r-plus-104b", "minicpm3-4b",
         "granite-moe-1b-a400m", "deepseek-v2-236b")
DENSE = ("llama3.2-1b", "qwen1.5-110b", "command-r-plus-104b", "minicpm3-4b")
B, S, CACHE = 2, 12, 20


def _reference_params(rcfg, seed):
    rparams = ref_transformer.init(rcfg, jax.random.PRNGKey(seed))
    if rcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = rparams["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(0.5 * rng.standard_normal(attn[name].shape), attn[name].dtype)
    return rparams


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    rparams = _reference_params(rcfg, 11)
    return arch, rcfg, cfg, rparams, lm_params_from_jax(rparams, device="cpu")


def _tokens(seed, vocab, b=B, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _assert_tree_close(ours, ref, tol):
    assert ours.keys() == ref.keys()
    for k in ours:
        if isinstance(ours[k], dict):
            _assert_tree_close(ours[k], ref[k], tol)
        else:
            assert ours[k].shape == ref[k].shape, k
            np.testing.assert_allclose(ours[k], np.asarray(ref[k]), err_msg=k, **tol)


def test_params_tree_is_the_ports_own_init(model):
    """The converted tree has the keys, shapes and dtypes of the port's own
    init (a stacked dense prefix for deepseek; no lm_head when tied)."""
    arch, rcfg, cfg, rparams, params = model
    gen = torch.Generator().manual_seed(0)
    own = transformer.init(cfg, gen)

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else (tuple(v.shape), v.dtype) for k, v in t.items()}

    assert shapes(own) == shapes(params)
    assert ("prefix_layers" in params) == (arch == "deepseek-v2-236b")
    assert ("lm_head" in params) == (not cfg.tie_embeddings)


def test_forward_matches_the_reference(model):
    arch, rcfg, cfg, rparams, params = model
    tok = _tokens(0, cfg.vocab_size)
    rlogits, raux = ref_transformer.forward(rparams, rcfg, jnp.asarray(tok))
    before = fa_mod.launches
    for use_kernels in (True, False):
        logits, aux = transformer.forward(params, cfg, torch.from_numpy(tok), use_kernels=use_kernels)
        assert logits.shape == (B, S, cfg.padded_vocab)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
        np.testing.assert_allclose(float(aux), float(raux), **TOL)
    assert fa_mod.launches == before  # CPU: plain versions only
    assert (float(raux) > 0) == (cfg.num_experts > 0)


def test_prefill_and_decode_match_the_reference(model):
    """The prefill's last logits and its cache (padded to the capacity),
    then three decode steps from that cache."""
    arch, rcfg, cfg, rparams, params = model
    tok = _tokens(1, cfg.vocab_size, s=S + 3)
    rlast, rcache = ref_transformer.prefill(rparams, rcfg, jnp.asarray(tok[:, :S]), CACHE)
    last, cache = transformer.prefill(params, cfg, torch.from_numpy(tok[:, :S]), CACHE)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), **TOL)
    _assert_tree_close(_np(cache), rcache, TOL)
    zero = transformer.init_cache(params, cfg, B, CACHE)
    assert ({k: {kk: tuple(vv.shape) for kk, vv in v.items()} for k, v in zero.items()}
            == {k: {kk: vv.shape for kk, vv in v.items()} for k, v in rcache.items()})
    rb, b = ref_build_model(rcfg), build_model(cfg)
    for t in range(S, S + 3):
        pos = np.full((B,), t, np.int32)
        rl, rcache = rb.decode(rparams, jnp.asarray(tok[:, t]), rcache, jnp.asarray(pos))
        lg, cache = b.decode(params, torch.from_numpy(tok[:, t]), cache,
                             torch.from_numpy(pos.astype(np.int64)))
        np.testing.assert_allclose(lg.numpy(), np.asarray(rl), **TOL)
    _assert_tree_close(_np(cache), rcache, TOL)


def test_decode_stepped_over_the_prompt(model):
    """Decode stepped over a prompt from a zero cache: against the forward
    (2e-2) for the non-MoE models; an MoE decode step routes its tokens as
    one group with its own capacity, so there it is held to the reference's
    decode stepped the same way (1e-4)."""
    arch, rcfg, cfg, rparams, params = model
    tok = _tokens(2, cfg.vocab_size, b=1, s=8)
    b = build_model(cfg)
    cache = b.init_cache(params, 1, 32)
    steps = []
    for t in range(tok.shape[1]):
        lg, cache = b.decode(params, torch.from_numpy(tok[:, t]), cache, torch.full((1,), t))
        steps.append(lg)
    steps = torch.stack(steps, dim=1).numpy()
    if arch in DENSE:
        full, _ = transformer.forward(params, cfg, torch.from_numpy(tok))
        np.testing.assert_allclose(steps, full.numpy(), **DECODE_TOL)
        return
    rb = ref_build_model(rcfg)
    rdecode = jax.jit(rb.decode)
    rcache, rsteps = rb.init_cache(rparams, 1, 32), []
    for t in range(tok.shape[1]):
        rl, rcache = rdecode(rparams, jnp.asarray(tok[:, t]), rcache, jnp.full((1,), t, jnp.int32))
        rsteps.append(np.asarray(rl))
    np.testing.assert_allclose(steps, np.stack(rsteps, axis=1), **TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "minicpm3-4b"])
def test_bf16_forward(arch):
    """bf16, as the models serve: the port's bf16 logits against the
    reference's bf16 logits, 5e-2 of the largest."""
    rcfg = ref_get_config(arch).reduced(dtype="bfloat16")
    cfg = get_config(arch).reduced(dtype="bfloat16")
    rparams = ref_transformer.init(rcfg, jax.random.PRNGKey(5))
    params = lm_params_from_jax(rparams, device="cpu")
    tok = _tokens(3, cfg.vocab_size)
    ref = np.asarray(ref_transformer.forward(rparams, rcfg, jnp.asarray(tok))[0].astype(jnp.float32))
    ours, _ = transformer.forward(params, cfg, torch.from_numpy(tok))
    assert ours.dtype == torch.bfloat16
    rel = np.abs(ours.float().numpy() - ref).max() / np.abs(ref).max()
    assert rel <= BF16_REL, rel

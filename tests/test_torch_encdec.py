"""The port's whisper encoder–decoder (whisper-large-v3, reduced: 2 + 2
layers, d = 128, 16 frames, f32) against the reference's
``repro.models.encdec``.

Parameters are the reference's own init, carried over by
``lm_params_from_jax`` (its QKV biases, zero at init, drawn so that they
count); tokens and frames come from a seed with numpy.  Tolerances: the
encoder, the forward, the prefill (its last logits and both caches) and
decode steps from the prefill's cache against the reference 1e-4; decode
against the forward 2e-2, the first token through a prefill as the
reference's test does (tests/test_models_smoke.py:126-137).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import encdec as ref_encdec
from repro_torch import lm_params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.models import build_model, encdec


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
MAX_SEQ = 40


@pytest.fixture(scope="module")
def model():
    rcfg, cfg = ref_get_config("whisper-large-v3").reduced(), get_config("whisper-large-v3").reduced()
    rparams = ref_encdec.init(rcfg, jax.random.PRNGKey(5), max_seq=MAX_SEQ)
    rng = np.random.default_rng(5)
    for stack in ("encoder", "decoder"):
        for part in ("attn", "cross") if stack == "decoder" else ("attn",):
            p = rparams[stack][part]
            for name in ("bq", "bk", "bv"):
                p[name] = jnp.asarray(0.5 * rng.standard_normal(p[name].shape), p[name].dtype)
    return rcfg, cfg, rparams, lm_params_from_jax(rparams, device="cpu")


def _inputs(seed, cfg, B=2, S=10):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return frames, rng.integers(0, cfg.vocab_size, (B, S))


def test_init_shapes(model):
    rcfg, cfg, rparams, params = model
    own = encdec.init(cfg, torch.Generator().manual_seed(0), max_seq=MAX_SEQ)
    assert tuple(own["dec_pos"]["pos_table"].shape) == (MAX_SEQ, cfg.d_model)
    assert {k: tuple(v.shape) for k, v in own["decoder"]["cross"].items()} == \
        {k: tuple(v.shape) for k, v in params["decoder"]["cross"].items()}


def test_encode_and_forward_match_the_reference(model):
    rcfg, cfg, rparams, params = model
    frames, tok = _inputs(0, cfg)
    renc = ref_encdec.encode(rparams, rcfg, jnp.asarray(frames))
    np.testing.assert_allclose(encdec.encode(params, cfg, torch.from_numpy(frames)).numpy(),
                               np.asarray(renc), **TOL)
    ref = np.asarray(ref_encdec.forward(rparams, rcfg, jnp.asarray(frames), jnp.asarray(tok)))
    before = fa_mod.launches
    for use_kernels in (True, False):
        ours = encdec.forward(params, cfg, torch.from_numpy(frames), torch.from_numpy(tok),
                              use_kernels=use_kernels)
        np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    assert fa_mod.launches == before  # CPU: the plain version


def test_prefill_and_decode_match_the_reference(model):
    rcfg, cfg, rparams, params = model
    frames, tok = _inputs(1, cfg, S=13)
    B, S, T = 2, 10, 24
    rb, b = ref_build_model(rcfg), build_model(cfg)
    rbatch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(tok[:, :S])}
    batch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tok[:, :S])}
    rlast, rcache = rb.prefill(rparams, rbatch, T)
    last, cache = b.prefill(params, batch, T)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), **TOL)
    zero = b.init_cache(params, B, T)
    for k in ("self_k", "self_v", "cross_k", "cross_v"):
        assert tuple(cache[k].shape) == tuple(zero[k].shape) == rcache[k].shape
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]), **TOL)
    for t in range(S, S + 3):
        pos = np.full((B,), t, np.int32)
        rl, rcache = rb.decode(rparams, jnp.asarray(tok[:, t]), rcache, jnp.asarray(pos))
        lg, cache = b.decode(params, torch.from_numpy(tok[:, t]), cache,
                             torch.from_numpy(pos.astype(np.int64)))
        np.testing.assert_allclose(lg.numpy(), np.asarray(rl), **TOL)
    np.testing.assert_allclose(cache["self_k"].numpy(), np.asarray(rcache["self_k"]), **TOL)


def test_decode_matches_the_forward(model):
    """The reference test's recipe: the first token's logits from the
    forward, its cross caches from a one-token prefill, then decode."""
    rcfg, cfg, rparams, params = model
    frames, tok = _inputs(2, cfg, B=1, S=8)
    b = build_model(cfg)
    full = encdec.forward(params, cfg, torch.from_numpy(frames), torch.from_numpy(tok))
    _, cache = b.prefill(params, {"frames": torch.from_numpy(frames),
                                  "tokens": torch.from_numpy(tok[:, :1])}, 32)
    steps = [full[:, 0]]
    for t in range(1, tok.shape[1]):
        lg, cache = b.decode(params, torch.from_numpy(tok[:, t]), cache, torch.full((1,), t))
        steps.append(lg)
    np.testing.assert_allclose(torch.stack(steps, dim=1).numpy(), full.numpy(), **DECODE_TOL)

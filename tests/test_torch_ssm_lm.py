"""The port's Mamba-2 LM (mamba2-370m, reduced: 2 layers, d = 128, ds =
16, f32) against the reference's ``repro.models.ssm_lm``.

Parameters are the reference's own init, carried over by
``lm_params_from_jax``; tokens come from a seed with numpy.  Tolerances:
the forward, the prefill's last logits and decode steps against the
reference 1e-4; decode stepped over the prompt against the forward 2e-2
(tests/test_models_smoke.py:143-148).  The prefill's cache is a zero
state, as the reference's ``_ssm_prefill`` returns (ROADMAP Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import ssm_lm as ref_ssm_lm
from repro_torch import lm_params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
from repro_torch.models import build_model, make_prefill_step, ssm_lm


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


@pytest.fixture(scope="module")
def model():
    rcfg, cfg = ref_get_config("mamba2-370m").reduced(), get_config("mamba2-370m").reduced()
    rparams = ref_ssm_lm.init(rcfg, jax.random.PRNGKey(3))
    return rcfg, cfg, rparams, lm_params_from_jax(rparams, device="cpu")


def _tokens(seed, vocab, b=2, s=32):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_config_and_params(model):
    rcfg, cfg, rparams, params = model
    full = get_config("mamba2-370m")
    assert (full.ssm_heads, full.ssm_head_dim, full.ssm_state, full.ssm_chunk) == (32, 64, 128, 128)
    assert "lm_head" not in params and cfg.tie_embeddings
    own = ssm_lm.init(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own["layers"]["mamba"].items()} == \
        {k: tuple(v.shape) for k, v in params["layers"]["mamba"].items()}


def test_forward_matches_the_reference(model):
    rcfg, cfg, rparams, params = model
    tok = _tokens(0, cfg.vocab_size)
    ref = np.asarray(ref_ssm_lm.forward(rparams, rcfg, jnp.asarray(tok)))
    before = ssd_mod.launches
    for use_kernels in (True, False):
        ours = ssm_lm.forward(params, cfg, torch.from_numpy(tok), use_kernels=use_kernels)
        assert ours.shape == (2, 32, cfg.padded_vocab)
        np.testing.assert_allclose(ours.numpy(), ref, **TOL)
    assert ssd_mod.launches == before  # CPU: the plain version


def test_prefill_returns_the_last_logits_and_a_zero_state(model):
    rcfg, cfg, rparams, params = model
    tok = _tokens(1, cfg.vocab_size)
    rlast, rcache = ref_build_model(rcfg).prefill(rparams, {"tokens": jnp.asarray(tok)}, 40)
    last, cache = build_model(cfg).prefill(params, {"tokens": torch.from_numpy(tok)}, 40)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), **TOL)
    for k in ("conv", "ssd"):
        assert tuple(cache[k].shape) == rcache[k].shape
        assert not cache[k].any() and not np.asarray(rcache[k]).any()
    nxt, _ = make_prefill_step(build_model(cfg), 40)(params, {"tokens": torch.from_numpy(tok)})
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(rlast).argmax(-1))


def test_decode_matches_the_reference_and_the_forward(model):
    rcfg, cfg, rparams, params = model
    B, S = 2, 8
    tok = _tokens(2, cfg.vocab_size, B, S)
    rb, b = ref_build_model(rcfg), build_model(cfg)
    rcache, cache = rb.init_cache(rparams, B, 16), b.init_cache(params, B, 16)
    steps = []
    for t in range(S):
        rl, rcache = rb.decode(rparams, jnp.asarray(tok[:, t]), rcache, jnp.full((B,), t, jnp.int32))
        lg, cache = b.decode(params, torch.from_numpy(tok[:, t]), cache, torch.full((B,), t))
        if t < 3:
            np.testing.assert_allclose(lg.numpy(), np.asarray(rl), **TOL)
        steps.append(lg)
    for k in ("conv", "ssd"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(rcache[k]), **TOL)
    full = ssm_lm.forward(params, cfg, torch.from_numpy(tok))
    np.testing.assert_allclose(torch.stack(steps, dim=1).numpy(), full.numpy(), **DECODE_TOL)

"""The per-layer rematerialisation of the port against the reference's
``jax.checkpoint`` sites, on reduced configs in f32 on the CPU.

``models.layers.remat`` wraps exactly what the reference wraps: the main
``layers`` stack's blocks of the transformer (not the dense prefix), each
Mamba-2 block of mamba2 and of zamba2 (groups and tail), each call of
zamba2's shared attention block, each whisper encoder and decoder block,
and the per-q-chunk bodies of the chunked GQA and MLA attention.  For each
family:

  * the loss and every gradient leaf are bitwise equal with the helper and
    with it patched out (the recompute gives the forward's bits);
  * the wrapped bodies are the reference's sites, counted call by call;
  * a ``saved_tensors_hooks`` count shows fewer bytes kept for the
    backward with the helper.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, layers, loss_and_grads
from repro_torch.tree import tree_flatten_with_paths, tree_leaves

B, S = 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chunked(arch, **red):
    cfg = get_config(arch).reduced(**red)
    return dataclasses.replace(cfg, chunked_attention=True, attn_chunk=4)


# name → (config, the bodies the reference checkpoints in one forward, by
# the qualified name of the function handed to ``remat``)
CASES = {
    "dense": (get_config("llama3.2-1b").reduced(num_layers=3),
              {"forward.<locals>.body": 3}),
    "moe_prefix": (get_config("deepseek-v2-236b").reduced(num_layers=3),
                   {"forward.<locals>.body": 2}),
    "mla": (get_config("minicpm3-4b").reduced(), {"forward.<locals>.body": 2}),
    "mamba2": (get_config("mamba2-370m").reduced(), {"forward.<locals>.body": 2}),
    "zamba2": (get_config("zamba2-7b").reduced(),
               {"forward.<locals>.mamba_body": 7, "forward.<locals>.shared_body": 2}),
    "whisper": (get_config("whisper-large-v3").reduced(),
                {"encode.<locals>.body": 2, "forward.<locals>.body": 2}),
    "chunked_gqa": (_chunked("llama3.2-1b"),
                    {"forward.<locals>.body": 2, "_chunked_plain.<locals>.one_q_chunk": 4}),
    "chunked_mla": (_chunked("minicpm3-4b"),
                    {"forward.<locals>.body": 2,
                     "_mla_chunked_plain.<locals>.one_q_chunk": 4}),
}


def _plain(fn, *args):
    return fn(*args)


def _params_and_batch(cfg):
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), max_seq=S + 8)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    return bundle, params, batch


def _run(bundle, params, batch, monkeypatch, remat):
    """(loss, grads, the remat calls by body, the bytes saved for backward)."""
    calls: dict = {}

    def counted(fn, *args):
        name = fn.__qualname__
        calls[name] = calls.get(name, 0) + 1
        return remat(fn, *args)

    saved = []

    def pack(t):
        saved.append(t.untyped_storage().nbytes() if t.layout == torch.strided else 0)
        return t

    monkeypatch.setattr(layers, "remat", counted)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, grads = loss_and_grads(bundle, params, batch)
    monkeypatch.undo()
    return loss, grads, calls, sum(saved)


@pytest.mark.parametrize("case", list(CASES))
def test_remat_keeps_the_bits_and_saves_less(case, monkeypatch):
    cfg, sites = CASES[case]
    bundle, params, batch = _params_and_batch(cfg)
    loss, grads, calls, saved = _run(bundle, params, batch, monkeypatch, layers.remat)
    loss0, grads0, calls0, saved0 = _run(bundle, params, batch, monkeypatch, _plain)

    # the backward's recompute of a layer enters its q-chunk bodies again
    assert calls0 == sites and set(calls) == set(sites)
    assert torch.equal(loss, loss0) and torch.isfinite(loss)
    paths, leaves = tree_flatten_with_paths(grads)
    leaves0 = tree_leaves(grads0)
    assert len(leaves) == len(leaves0)
    for path, g, g0 in zip(paths, leaves, leaves0):
        assert (g is None) == (g0 is None), path
        if g is not None:
            assert torch.equal(g, g0), path
    assert 0 < saved < saved0


def test_dense_prefix_is_not_rematerialised(monkeypatch):
    """deepseek's first dense layer runs bare, as the reference's
    ``pref_body``: the one block of the main stack per layer is wrapped,
    and the prefix block never enters ``remat``."""
    cfg, _ = CASES["moe_prefix"]
    bundle, params, batch = _params_and_batch(cfg)
    seen = []

    def spy(fn, *args):
        seen.append(args[0]["moe"]["router"].shape if "moe" in args[0] else "dense")
        return fn(*args)

    monkeypatch.setattr(layers, "remat", spy)
    loss_and_grads(bundle, params, batch)
    assert len(seen) == cfg.num_layers - cfg.first_dense_layers
    assert "dense" not in seen


def test_remat_is_the_plain_call_without_grad(monkeypatch):
    """Serving runs under no grad: ``remat`` calls the body as it is, and
    never enters ``torch.utils.checkpoint``."""

    def refuse(*a, **k):
        raise AssertionError("checkpoint under no grad")

    monkeypatch.setattr(layers, "checkpoint", refuse)
    cfg, _ = CASES["dense"]
    bundle, params, batch = _params_and_batch(cfg)
    with torch.no_grad():
        logits, _ = bundle.prefill(params, batch, S + 4, False)
    assert torch.isfinite(logits).all()

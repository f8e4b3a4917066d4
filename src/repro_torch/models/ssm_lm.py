"""Mamba-2 language model (attention-free, sub-quadratic) — the
counterpart of ``repro.models.ssm_lm``: serving and the training loss.

The forward runs B5 in every block on CUDA tensors (``use_kernels=True``;
the reference's ``use_pallas``); decode is the O(1)-per-token recurrence
of ``ssm.mamba2_decode``.  The reference's ``jax.lax.scan`` over the
stacked blocks is a Python loop, each block rematerialised as the
reference's ``jax.checkpoint`` does it (``layers.remat``; on a mesh the
block gathers its parameters inside).  :func:`loss_fn` runs the plain chunked
scan (the reference's ``use_pallas=False``): B5 has no backward.
"""

from __future__ import annotations

import torch

from ..distributed.sharding import params_for_use, shard_activations
from . import layers
from .layers import (
    cross_entropy,
    embed,
    embedding_init,
    make_norm,
    normal_init,
    stacked_init,
    tree_index,
    tree_map,
    tree_stack,
    tree_unbind,
)
from .ssm import mamba2_decode, mamba2_full, mamba2_init, mamba2_init_cache


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init(cfg, gen):
    """Parameters drawn from ``gen`` (a torch.Generator), on its device."""
    dtype = _dtype(cfg)
    norm_init, _ = make_norm(cfg)
    dev = gen.device
    params = {"embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model, dtype)}
    params["layers"] = stacked_init(cfg.num_layers, lambda: {
        "norm": norm_init(cfg.d_model, dtype, dev), "mamba": mamba2_init(gen, cfg, dtype)})
    params["final_norm"] = norm_init(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model**-0.5, dtype)
    return params


def _unembed(params, cfg, h):
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["table"].T
    else:
        logits = h @ params["lm_head"]
    return shard_activations(logits, *([None] * (logits.dim() - 2)), "model", grad=True)


def forward(params, cfg, tokens, *, use_kernels=True):
    """tokens (B, S) → logits (B, S, padded_vocab)."""
    _, norm = make_norm(cfg)
    h = shard_activations(embed(params["embed"], tokens), None, None)

    def body(p, h):
        p = params_for_use(p)
        out = mamba2_full(p["mamba"], cfg, norm(p["norm"], h), use_kernel=use_kernels)
        return h + shard_activations(out, None, None)

    for p in tree_unbind(params["layers"], cfg.num_layers):
        h = layers.remat(body, p, h)
    return _unembed(params, cfg, norm(params["final_norm"], h))


def loss_fn(params, cfg, batch, *, use_kernels=False):
    """Next-token CE over batch["tokens"] (B, S + 1), on the plain paths."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens[:, :-1], use_kernels=use_kernels)
    return cross_entropy(logits, tokens[:, 1:], cfg.vocab_size)


def init_cache(params, cfg, batch, cache_len):
    """Zero (conv window, SSD state) per layer; O(1) in sequence length
    (``cache_len`` only for API parity, as in the reference)."""
    one = mamba2_init_cache(cfg, batch, _dtype(cfg), params["embed"]["table"].device)
    return tree_map(lambda x: x.new_zeros((cfg.num_layers,) + tuple(x.shape)), one)


def decode_step(params, cfg, token, cache, pos):
    """token (B,), pos (B,) → (logits (B, padded_vocab), new cache)."""
    _, norm = make_norm(cfg)
    h = embed(params["embed"], token[:, None])
    outs = []
    for i in range(cfg.num_layers):
        p = tree_index(params["layers"], i)
        out, c = mamba2_decode(p["mamba"], cfg, norm(p["norm"], h), tree_index(cache, i), pos)
        h = h + shard_activations(out, None, None)
        outs.append(c)
    h = norm(params["final_norm"], h)
    return _unembed(params, cfg, h)[:, 0], tree_stack(outs)

"""Zamba2-style hybrid: a Mamba-2 backbone with a *shared* attention block —
the counterpart of ``repro.models.hybrid`` (serving; ``loss_fn`` waits for
LM training, ROADMAP Queue A step 17).

Structure (period P = cfg.shared_attn_period):
  * num_layers Mamba-2 blocks, organised as G = num_layers // P groups of
    P plus a tail, their parameters stacked (G, P, ...) and (tail, ...) as
    in the reference;
  * after each full group, ONE shared transformer block (GQA + MLP at
    width 2·d on concat(hidden, initial embedding), projected back to d)
    with per-group input-norm gains.

The reference's ``jax.lax.scan`` over the stacked parameters is a Python
loop here, and ``jax.checkpoint`` has no role in a serving forward.  On
CUDA tensors the forward runs B5 in every Mamba-2 block and B4 in every
shared-attention invocation (``use_kernels=True``).

Decode carries (mamba conv / SSD states per layer) + (one KV cache per
shared-attention invocation, G of them).
"""

from __future__ import annotations

import dataclasses

import torch

from . import attention as attn
from .layers import (
    at_least_f32,
    embed,
    embedding_init,
    make_norm,
    mlp_apply,
    mlp_init,
    normal_init,
)
from .ssm import mamba2_decode, mamba2_full, mamba2_init, mamba2_init_cache


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _attn_cfg(cfg):
    """The shared block runs at width 2·d (concat of hidden + embedding)."""
    return dataclasses.replace(
        cfg,
        d_model=2 * cfg.d_model,
        head_dim=(2 * cfg.d_model) // cfg.num_heads,
        d_ff=cfg.d_ff,
        attn_type="gqa",
    )


def _group_shape(cfg):
    P = cfg.shared_attn_period
    G = cfg.num_layers // P
    tail = cfg.num_layers - G * P
    return P, G, tail


def _tree_map(fn, *trees):
    """fn over the leaves of nested dicts with the same keys."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _index(tree, i):
    return _tree_map(lambda x: x[i], tree)


def _stack(trees):
    return _tree_map(lambda *xs: torch.stack(xs), *trees)


def _stacked_init(n, make):
    """``make()`` called n times, its trees stacked on a new leading axis:
    the stacked tensors are allocated once and filled layer by layer, so
    the peak is the stack plus one layer."""
    first = make()
    out = _tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    _tree_map(lambda o, x: o[0].copy_(x), out, first)
    del first
    for i in range(1, n):
        _tree_map(lambda o, x: o[i].copy_(x), out, make())
    return out


def init(cfg, gen):
    """Parameters drawn from ``gen`` (a torch.Generator), on its device."""
    dtype = _dtype(cfg)
    norm_init, _ = make_norm(cfg)
    P, G, tail = _group_shape(cfg)
    acfg = _attn_cfg(cfg)
    dev = gen.device

    def mamba_block():
        return {"norm": norm_init(cfg.d_model, dtype, dev), "mamba": mamba2_init(gen, cfg, dtype)}

    grouped = _tree_map(
        lambda x: x.view((G, P) + tuple(x.shape[1:])), _stacked_init(G * P, mamba_block)
    )
    params = {
        "embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "groups": grouped,
        "shared_attn": {
            "attn": attn.gqa_init(gen, acfg, dtype),
            "mlp": mlp_init(gen, acfg.d_model, acfg.d_ff, acfg, dtype),
            "mlp_norm": norm_init(acfg.d_model, dtype, dev),
            "down": normal_init(gen, (acfg.d_model, cfg.d_model), acfg.d_model**-0.5, dtype),
        },
        # per-invocation adapters (the non-shared part of Zamba2's scheme)
        "group_norms": torch.ones((G, 2 * cfg.d_model), dtype=dtype, device=dev),
        "final_norm": norm_init(cfg.d_model, dtype, dev),
        "lm_head": normal_init(gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model**-0.5, dtype),
    }
    if tail:
        params["tail"] = _stacked_init(tail, mamba_block)
    return params


def _rms_gain(x, scale, eps=1e-5):
    x32 = at_least_f32(x)
    out = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (out * at_least_f32(scale)).to(x.dtype)


def _shared_attn_full(sp, acfg, cfg, h, h0, gain, *, use_kernel=True):
    x = torch.cat([h, h0], dim=-1)
    x = _rms_gain(x, gain)
    a = attn.gqa_full(sp["attn"], acfg, x, causal=True, use_kernel=use_kernel)
    a = a + mlp_apply(sp["mlp"], _rms_gain(a, sp["mlp_norm"]["scale"]), acfg)
    return h + a @ sp["down"]


def forward(params, cfg, tokens, *, use_kernels=True):
    """tokens (B, S) → logits (B, S, padded_vocab).  ``use_kernels`` runs
    B5 in each Mamba-2 block and B4 in each shared-attention invocation
    (on CPU tensors their plain versions); False takes the plain paths on
    any device (the reference's ``use_pallas`` / ``use_flash``)."""
    _, norm = make_norm(cfg)
    P, G, tail = _group_shape(cfg)
    acfg = _attn_cfg(cfg)
    h0 = embed(params["embed"], tokens)
    h = h0

    def mamba_body(p, h):
        return h + mamba2_full(p["mamba"], cfg, norm(p["norm"], h), use_kernel=use_kernels)

    shared = params["shared_attn"]
    for g in range(G):
        gp = _index(params["groups"], g)
        for j in range(P):
            h = mamba_body(_index(gp, j), h)
        h = _shared_attn_full(shared, acfg, cfg, h, h0, params["group_norms"][g],
                              use_kernel=use_kernels)
    for j in range(tail):
        h = mamba_body(_index(params["tail"], j), h)

    h = norm(params["final_norm"], h)
    return h @ params["lm_head"]


def init_cache(params, cfg, batch, cache_len):
    dtype = _dtype(cfg)
    P, G, tail = _group_shape(cfg)
    acfg = _attn_cfg(cfg)
    KV, hd = acfg.num_kv_heads, acfg.resolved_head_dim
    dev = params["lm_head"].device
    one = mamba2_init_cache(cfg, batch, dtype, dev)
    return {
        "groups": _tree_map(lambda x: x.new_zeros((G, P) + tuple(x.shape)), one),
        "tail": _tree_map(lambda x: x.new_zeros((tail,) + tuple(x.shape)), one) if tail else None,
        "attn_k": torch.zeros((G, batch, cache_len, KV, hd), dtype=dtype, device=dev),
        "attn_v": torch.zeros((G, batch, cache_len, KV, hd), dtype=dtype, device=dev),
    }


def decode_step(params, cfg, token, cache, pos):
    """token (B,), pos (B,) → (logits (B, padded_vocab), new cache)."""
    _, norm = make_norm(cfg)
    P, G, tail = _group_shape(cfg)
    acfg = _attn_cfg(cfg)
    h0 = embed(params["embed"], token[:, None])
    h = h0
    shared = params["shared_attn"]

    def mamba_step(h, p, c):
        out, c2 = mamba2_decode(p["mamba"], cfg, norm(p["norm"], h), c, pos)
        return h + out, c2

    new_groups, new_k, new_v = [], [], []
    for g in range(G):
        gp, gc = _index(params["groups"], g), _index(cache["groups"], g)
        layer_caches = []
        for j in range(P):
            h, c2 = mamba_step(h, _index(gp, j), _index(gc, j))
            layer_caches.append(c2)
        new_groups.append(_stack(layer_caches))
        x = torch.cat([h, h0], dim=-1)
        x = _rms_gain(x, params["group_norms"][g])
        a, kv = attn.gqa_decode(shared["attn"], acfg, x,
                                {"k": cache["attn_k"][g], "v": cache["attn_v"][g]}, pos)
        a = a + mlp_apply(shared["mlp"], _rms_gain(a, shared["mlp_norm"]["scale"]), acfg)
        h = h + a @ shared["down"]
        new_k.append(kv["k"])
        new_v.append(kv["v"])

    new_tail = cache.get("tail")
    if tail:
        tail_caches = []
        for j in range(tail):
            h, c2 = mamba_step(h, _index(params["tail"], j), _index(cache["tail"], j))
            tail_caches.append(c2)
        new_tail = _stack(tail_caches)

    h = norm(params["final_norm"], h)
    logits = (h @ params["lm_head"])[:, 0]
    new_cache = {"groups": _stack(new_groups), "tail": new_tail,
                 "attn_k": torch.stack(new_k), "attn_v": torch.stack(new_v)}
    return logits, new_cache

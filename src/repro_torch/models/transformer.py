"""Decoder-only transformer LM covering the dense / MoE / MLA families —
the counterpart of ``repro.models.transformer``: serving and the training
loss.

Layers are stacked as in the reference: ``layers`` (L, ...) and, for an
MoE config with ``first_dense_layers``, a dense ``prefix_layers`` stack
before them.  The reference's ``jax.lax.scan`` over the stacks is a Python
loop here.  Its ``jax.checkpoint`` is kept where it stands: every block of
the main ``layers`` stack is rematerialised (``layers.remat``), the dense
prefix is not, and each block gathers its own parameters over the data
axes on a mesh, so the backward's recompute gathers them again.  On CUDA
tensors the GQA forward and prefill run B4 in every layer (``use_kernels=True``; the
reference's ``use_flash``); MLA, MoE and decode are plain torch, as in the
reference.  :func:`loss_fn` runs the plain paths (``use_kernels=False``,
the reference's ``use_flash=False``): B4 has no backward.
"""

from __future__ import annotations

import torch

from ..distributed.sharding import params_for_use, shard_activations, shard_cache_kv
from . import attention as attn
from . import layers
from .layers import (
    at_least_f32,
    cross_entropy,
    embed,
    embedding_init,
    make_norm,
    mlp_apply,
    mlp_init,
    normal_init,
    stacked_init,
    tree_index,
    tree_stack,
    tree_unbind,
)
from .moe import moe_apply, moe_init


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _attn_init(gen, cfg, dtype):
    return attn.mla_init(gen, cfg, dtype) if cfg.attn_type == "mla" else attn.gqa_init(gen, cfg, dtype)


def block_init(gen, cfg, dtype, *, moe: bool):
    norm_init, _ = make_norm(cfg)
    dev = gen.device
    p = {
        "attn_norm": norm_init(cfg.d_model, dtype, dev),
        "attn": _attn_init(gen, cfg, dtype),
        "mlp_norm": norm_init(cfg.d_model, dtype, dev),
    }
    if moe:
        p["moe"] = moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg, dtype)
    return p


def _ffn(p, cfg, x, moe):
    """(y, aux): the block's MLP or MoE."""
    if moe:
        return moe_apply(p["moe"], cfg, x)
    return mlp_apply(p["mlp"], x, cfg), None


def block_apply(p, cfg, h, *, moe: bool, use_kernel=True):
    _, norm = make_norm(cfg)
    # SP: the residual stream lives sequence-sharded over "model", and
    # the norms and residual adds work on it; attention and the MLP take
    # the whole sequence (gathered after the norm, reduce-scattered back at
    # the residual add), where the reference leaves both moves to XLA
    sp = ("model", None) if cfg.use_sp else (None, None)
    h = shard_activations(h, *sp)
    x = norm(p["attn_norm"], h)
    if cfg.use_sp:
        x = shard_activations(x, None, None)
    a = attn.mla_full(p["attn"], cfg, x) if cfg.attn_type == "mla" \
        else attn.gqa_full(p["attn"], cfg, x, use_kernel=use_kernel)
    h = h + shard_activations(a, *sp)
    h = shard_activations(h, *sp)
    x = norm(p["mlp_norm"], h)
    if cfg.use_sp:
        x = shard_activations(x, None, None)
    y, aux = _ffn(p, cfg, x, moe)
    return h + shard_activations(y, *sp), aux


def block_prefill(p, cfg, h, cache_len, *, moe: bool, use_kernel=True):
    _, norm = make_norm(cfg)
    x = norm(p["attn_norm"], h)
    if cfg.attn_type == "mla":
        a, cache = attn.mla_prefill(p["attn"], cfg, x, cache_len)
    else:
        a, cache = attn.gqa_prefill(p["attn"], cfg, x, cache_len, use_kernel=use_kernel)
    # the residual stream stays batch-sharded and whole over "model" (the
    # reference's scan carry keeps its first layout): each branch's
    # pending sum is reduced before the add
    h = h + shard_activations(a, None, None)
    y, _ = _ffn(p, cfg, norm(p["mlp_norm"], h), moe)
    return h + shard_activations(y, None, None), cache


def block_decode(p, cfg, h, cache, pos, *, moe: bool):
    _, norm = make_norm(cfg)
    x = norm(p["attn_norm"], h)
    if cfg.attn_type == "mla":
        a, cache = attn.mla_decode(p["attn"], cfg, x, cache, pos)
    else:
        a, cache = attn.gqa_decode(p["attn"], cfg, x, cache, pos)
    h = h + shard_activations(a, None, None)
    y, _ = _ffn(p, cfg, norm(p["mlp_norm"], h), moe)
    return h + shard_activations(y, None, None), cache


def _n_prefix(cfg):
    return cfg.first_dense_layers if cfg.num_experts else 0


def _stacks(cfg):
    """(name, number of layers, moe) of each stack, in order."""
    n_prefix = _n_prefix(cfg)
    out = [("prefix_layers", n_prefix, False)] if n_prefix else []
    return out + [("layers", cfg.num_layers - n_prefix, cfg.num_experts > 0)]


def init(cfg, gen):
    """Parameters drawn from ``gen`` (a torch.Generator), on its device."""
    dtype = _dtype(cfg)
    norm_init, _ = make_norm(cfg)
    params = {"embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model, dtype)}
    for name, n, moe in _stacks(cfg):
        params[name] = stacked_init(n, lambda moe=moe: block_init(gen, cfg, dtype, moe=moe))
    params["final_norm"] = norm_init(cfg.d_model, dtype, gen.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal_init(gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model**-0.5, dtype)
    return params


def _unembed(params, cfg, h):
    if cfg.tie_embeddings:
        logits = h @ params["embed"]["table"].T
    else:
        logits = h @ params["lm_head"]
    # vocab-shard the logits (they dominate activation memory otherwise),
    # and their gradient: the loss's backward leaves it sequence-sharded
    # over "model", which the unembedding's weight gradient, a product over
    # the flattened (batch, sequence), cannot take
    return shard_activations(logits, *([None] * (logits.dim() - 2)), "model", grad=True)


def forward(params, cfg, tokens, *, use_kernels=True):
    """tokens (B, S) → (logits (B, S, padded_vocab), aux): B4 in every GQA
    layer on CUDA tensors with ``use_kernels`` (the plain versions on CPU
    tensors; False takes the plain paths on any device)."""
    _, norm = make_norm(cfg)
    h = shard_activations(embed(params["embed"], tokens), None, None)
    aux_total = torch.zeros((), dtype=at_least_f32(h).dtype, device=h.device)

    def body(p, h, moe):
        return block_apply(params_for_use(p), cfg, h, moe=moe, use_kernel=use_kernels)

    for name, n, moe in _stacks(cfg):
        for p in tree_unbind(params[name], n):
            # the reference rematerialises the main stack, not the dense prefix
            h, aux = layers.remat(body, p, h, moe) if name == "layers" else body(p, h, moe)
            if aux is not None:
                aux_total = aux_total + aux
    h = norm(params["final_norm"], h)
    if cfg.use_sp:  # the unembedding takes the whole sequence
        h = shard_activations(h, None, None)
    return _unembed(params, cfg, h), aux_total


def loss_fn(params, cfg, batch, *, use_kernels=False, aux_weight=0.01):
    """Next-token CE over batch["tokens"] (B, S + 1) plus ``aux_weight`` ×
    the MoE load-balance loss (0 for dense models), on the plain paths."""
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, tokens[:, :-1], use_kernels=use_kernels)
    ce = cross_entropy(logits, tokens[:, 1:], cfg.vocab_size)
    return ce + aux_weight * aux


def init_cache(params, cfg, batch, cache_len):
    """Zero decode cache (fixed capacity): per stack GQA k / v (n, B, T, KV,
    hd) or MLA c_kv (n, B, T, r_kv) / k_rope (n, B, T, r_rope)."""
    dtype = _dtype(cfg)
    dev = params["embed"]["table"].device
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim

    def one(n):
        if cfg.attn_type == "mla":
            return {
                "c_kv": torch.zeros((n, batch, cache_len, cfg.kv_lora_rank), dtype=dtype, device=dev),
                "k_rope": torch.zeros((n, batch, cache_len, cfg.rope_head_dim), dtype=dtype, device=dev),
            }
        return {
            "k": torch.zeros((n, batch, cache_len, KV, hd), dtype=dtype, device=dev),
            "v": torch.zeros((n, batch, cache_len, KV, hd), dtype=dtype, device=dev),
        }

    return {name: one(n) for name, n, _ in _stacks(cfg)}


def _shard_cache(cfg, cache):
    """A GQA layer's k / v laid out as ``shard_cache_kv`` says (the MLA
    latent cache follows its activations)."""
    if cfg.attn_type == "mla":
        return cache
    return {"k": shard_cache_kv(cache["k"]), "v": shard_cache_kv(cache["v"])}


def decode_step(params, cfg, token, cache, pos):
    """token (B,), pos (B,) → (logits (B, padded_vocab), new cache)."""
    _, norm = make_norm(cfg)
    h = embed(params["embed"], token[:, None])
    new_cache = {}
    for name, n, moe in _stacks(cfg):
        outs = []
        for i in range(n):
            h, c = block_decode(tree_index(params[name], i), cfg, h, tree_index(cache[name], i), pos,
                                moe=moe)
            outs.append(c)
        new_cache[name] = tree_stack(outs)
    h = norm(params["final_norm"], h)
    return _unembed(params, cfg, h)[:, 0], new_cache


def prefill(params, cfg, tokens, cache_len, *, use_kernels=True):
    """tokens (B, S) → (last-token logits, serving cache of capacity
    ``cache_len``, the prompt's entries at positions 0 … S − 1)."""
    _, norm = make_norm(cfg)
    h = shard_activations(embed(params["embed"], tokens), None, None)
    new_cache = {}
    for name, n, moe in _stacks(cfg):
        outs = []
        for i in range(n):
            h, c = block_prefill(tree_index(params[name], i), cfg, h, cache_len, moe=moe,
                                 use_kernel=use_kernels)
            outs.append(_shard_cache(cfg, c))
        new_cache[name] = tree_stack(outs)
    h = norm(params["final_norm"], h[:, -1:])
    return _unembed(params, cfg, h)[:, 0], new_cache

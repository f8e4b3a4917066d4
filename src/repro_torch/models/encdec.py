"""Whisper-style encoder–decoder (audio frontend stubbed) — the
counterpart of ``repro.models.encdec``: serving and the training loss.

The encoder takes precomputed frame embeddings (B, encoder_seq, d), as in
the reference; the decoder is a causal transformer with cross-attention.
Learned positions, pre-LayerNorm, GELU MLPs, QKV bias.  On CUDA tensors
(``use_kernels=True``; the reference's ``use_flash``) B4 runs the
encoder's attention (non-causal), the decoder's self-attention over a
prompt (causal) and every cross-attention (non-causal, in decode too: one
query position against the encoder's frames); decode's self-attention,
masked by the active lengths, is plain.  Every encoder and decoder block
of a forward is rematerialised, as the reference's ``jax.checkpoint``
does it (``layers.remat``; on a mesh a block gathers its parameters
inside).  :func:`loss_fn` runs the plain
paths (the reference's ``use_flash=False``): B4 has no backward.
"""

from __future__ import annotations

import torch

from ..distributed.sharding import params_for_use, shard_activations
from . import attention as attn
from . import layers
from .layers import (
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


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _enc_block_init(gen, cfg, dtype):
    norm_init, _ = make_norm(cfg)
    dev = gen.device
    return {
        "attn_norm": norm_init(cfg.d_model, dtype, dev),
        "attn": attn.gqa_init(gen, cfg, dtype),
        "mlp_norm": norm_init(cfg.d_model, dtype, dev),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg, dtype),
    }


def _dec_block_init(gen, cfg, dtype):
    norm_init, _ = make_norm(cfg)
    dev = gen.device
    return {
        "attn_norm": norm_init(cfg.d_model, dtype, dev),
        "attn": attn.gqa_init(gen, cfg, dtype),
        "cross_norm": norm_init(cfg.d_model, dtype, dev),
        "cross": attn.gqa_cross_init(gen, cfg, dtype),
        "mlp_norm": norm_init(cfg.d_model, dtype, dev),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg, dtype),
    }


def init(cfg, gen, *, max_seq=4096):
    """Parameters drawn from ``gen`` (a torch.Generator), on its device;
    ``max_seq`` rows of learned decoder positions."""
    dtype = _dtype(cfg)
    norm_init, _ = make_norm(cfg)
    dev = gen.device
    return {
        "embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model, dtype),
        "enc_pos": {"pos_table": normal_init(gen, (cfg.encoder_seq, cfg.d_model), 0.01, dtype)},
        "dec_pos": {"pos_table": normal_init(gen, (max_seq, cfg.d_model), 0.01, dtype)},
        "encoder": stacked_init(cfg.encoder_layers, lambda: _enc_block_init(gen, cfg, dtype)),
        "enc_final_norm": norm_init(cfg.d_model, dtype, dev),
        "decoder": stacked_init(cfg.num_layers, lambda: _dec_block_init(gen, cfg, dtype)),
        "final_norm": norm_init(cfg.d_model, dtype, dev),
        "lm_head": normal_init(gen, (cfg.d_model, cfg.padded_vocab), cfg.d_model**-0.5, dtype),
    }


def encode(params, cfg, frames, *, use_kernels=True):
    """frames (B, T, d) stub embeddings → encoder states."""
    _, norm = make_norm(cfg)
    T = frames.shape[1]
    h = shard_activations(frames + params["enc_pos"]["pos_table"][:T][None], None, None)

    def body(p, h):
        p = params_for_use(p)
        a = attn.gqa_full(p["attn"], cfg, norm(p["attn_norm"], h), causal=False,
                          use_kernel=use_kernels)
        h = h + shard_activations(a, None, None)
        return h + shard_activations(mlp_apply(p["mlp"], norm(p["mlp_norm"], h), cfg), None, None)

    for p in tree_unbind(params["encoder"], cfg.encoder_layers):
        h = layers.remat(body, p, h)
    return norm(params["enc_final_norm"], h)


def _embed_tokens(params, tokens):
    S = tokens.shape[1]
    return embed(params["embed"], tokens) + params["dec_pos"]["pos_table"][:S][None]


def forward(params, cfg, frames, tokens, *, use_kernels=True):
    """(frames (B, T, d), tokens (B, S)) → logits (B, S, padded_vocab)."""
    _, norm = make_norm(cfg)
    enc = encode(params, cfg, frames, use_kernels=use_kernels)
    h = shard_activations(_embed_tokens(params, tokens), None, None)

    def body(p, h, enc):
        p = params_for_use(p)
        a = attn.gqa_full(p["attn"], cfg, norm(p["attn_norm"], h), causal=True,
                          use_kernel=use_kernels)
        h = h + shard_activations(a, None, None)
        c, _ = attn.gqa_cross(p["cross"], cfg, norm(p["cross_norm"], h), enc, use_kernel=use_kernels)
        h = h + shard_activations(c, None, None)
        return h + shard_activations(mlp_apply(p["mlp"], norm(p["mlp_norm"], h), cfg), None, None)

    for p in tree_unbind(params["decoder"], cfg.num_layers):
        h = layers.remat(body, p, h, enc)
    h = norm(params["final_norm"], h)
    return shard_activations(h @ params["lm_head"], None, "model", grad=True)


def loss_fn(params, cfg, batch, *, use_kernels=False):
    """Next-token CE over batch["tokens"] (B, S + 1) given batch["frames"]
    (B, encoder_seq, d), on the plain paths."""
    logits = forward(params, cfg, batch["frames"], batch["tokens"][:, :-1],
                     use_kernels=use_kernels)
    return cross_entropy(logits, batch["tokens"][:, 1:], cfg.vocab_size)


# -- serving -------------------------------------------------------------------


def init_cache(params, cfg, batch, cache_len):
    dtype = _dtype(cfg)
    dev = params["lm_head"].device
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    L = cfg.num_layers

    def zeros(T):
        return torch.zeros((L, batch, T, KV, hd), dtype=dtype, device=dev)

    return {"self_k": zeros(cache_len), "self_v": zeros(cache_len),
            "cross_k": zeros(cfg.encoder_seq), "cross_v": zeros(cfg.encoder_seq)}


def prefill(params, cfg, frames, tokens, cache_len, *, use_kernels=True):
    """Encode + run the decoder over the prompt; build the self- and
    cross-attention caches.  → (last-token logits, cache)."""
    _, norm = make_norm(cfg)
    enc = encode(params, cfg, frames, use_kernels=use_kernels)
    h = _embed_tokens(params, tokens)
    self_caches, cross_caches = [], []
    for i in range(cfg.num_layers):
        p = tree_index(params["decoder"], i)
        a, self_cache = attn.gqa_prefill(p["attn"], cfg, norm(p["attn_norm"], h), cache_len,
                                         use_kernel=use_kernels)
        h = h + shard_activations(a, None, None)
        c, cross_cache = attn.gqa_cross(p["cross"], cfg, norm(p["cross_norm"], h), enc,
                                        use_kernel=use_kernels)
        h = h + shard_activations(c, None, None)
        h = h + shard_activations(mlp_apply(p["mlp"], norm(p["mlp_norm"], h), cfg), None, None)
        self_caches.append(self_cache)
        cross_caches.append(cross_cache)
    h = norm(params["final_norm"], h[:, -1:])
    selfs, crosses = tree_stack(self_caches), tree_stack(cross_caches)
    cache = {"self_k": selfs["k"], "self_v": selfs["v"],
             "cross_k": crosses["k"], "cross_v": crosses["v"]}
    return shard_activations((h @ params["lm_head"])[:, 0], "model"), cache


def decode_step(params, cfg, token, cache, pos):
    """token (B,), pos (B,) → (logits (B, padded_vocab), new cache); the
    cross caches are read, never written (B4 on CUDA tensors, one query
    position against the encoder's frames)."""
    _, norm = make_norm(cfg)
    h = embed(params["embed"], token[:, None]) + params["dec_pos"]["pos_table"][pos][:, None]
    new_k, new_v = [], []
    for i in range(cfg.num_layers):
        p = tree_index(params["decoder"], i)
        a, new_self = attn.gqa_decode(p["attn"], cfg, norm(p["attn_norm"], h),
                                      {"k": cache["self_k"][i], "v": cache["self_v"][i]}, pos)
        h = h + shard_activations(a, None, None)
        c, _ = attn.gqa_cross(p["cross"], cfg, norm(p["cross_norm"], h), None,
                              enc_cache={"k": cache["cross_k"][i], "v": cache["cross_v"][i]})
        h = h + shard_activations(c, None, None)
        h = h + shard_activations(mlp_apply(p["mlp"], norm(p["mlp_norm"], h), cfg), None, None)
        new_k.append(new_self["k"])
        new_v.append(new_self["v"])
    h = norm(params["final_norm"], h)
    logits = shard_activations((h @ params["lm_head"])[:, 0], "model")
    return logits, dict(cache, self_k=torch.stack(new_k), self_v=torch.stack(new_v))

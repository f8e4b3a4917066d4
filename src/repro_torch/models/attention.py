"""Attention, the GQA part — the counterpart of ``repro.models.attention``.

Three entry modes, as in the reference:
  * full     — a whole sequence (training / prefill forward);
  * prefill  — a full pass that also returns the serving cache;
  * decode   — one new token against a fixed-capacity cache.

On CUDA tensors the full and prefill passes run B4, the hand-written flash
attention kernel (``use_kernel=True``, the default; the reference's
``use_flash``); decode, masked by the active lengths, runs the plain path,
as in the reference.  MLA, ``_sdpa_chunked`` and cross-attention are not
ported yet (ROADMAP Queue A step 17); the reference's sharding hints are
the identity on one device and are left out (the LM sharding rules, step
17).
"""

from __future__ import annotations

import torch

from ..configs.base import NotPortedError
from ..kernels.flash_attention.ops import flash_attention
from .layers import apply_rope, at_least_f32, normal_init

NEG_INF = -1e30


def _sdpa(q, k, v, *, causal, kv_len=None, use_kernel=True):
    """q (B,S,H,hd), k/v (B,T,KV,hd) → (B,S,H,hd). f32 softmax.

    kv_len: optional (B,) active lengths for decode masking.  Without it,
    ``use_kernel`` takes B4 (the plain flash version on CPU tensors)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    group = H // KV

    if use_kernel and kv_len is None:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal)
        return out.transpose(1, 2)

    qg = q.reshape(B, S, KV, group, hd)
    scores = at_least_f32(torch.einsum("bskgh,btkh->bkgst", qg, k))
    scores = scores * (hd**-0.5)
    if causal and S > 1:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    if kv_len is not None:
        valid = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]  # (B, T)
        scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, hd)


def _check_not_chunked(cfg, S):
    """The reference takes ``_sdpa_chunked`` here, which is not ported."""
    c = min(cfg.attn_chunk, S)
    if cfg.chunked_attention and S > 1 and S % c == 0:
        raise NotPortedError(
            "chunked_attention (the reference's _sdpa_chunked) is not ported: "
            "ROADMAP Queue A step 17"
        )


def gqa_init(gen, cfg, dtype):
    d = cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    scale = d**-0.5
    p = {
        "wq": normal_init(gen, (d, H * hd), scale, dtype),
        "wk": normal_init(gen, (d, KV * hd), scale, dtype),
        "wv": normal_init(gen, (d, KV * hd), scale, dtype),
        "wo": normal_init(gen, (H * hd, d), scale, dtype),
    }
    if cfg.qkv_bias:
        p.update(
            bq=torch.zeros((H * hd,), dtype=dtype, device=gen.device),
            bk=torch.zeros((KV * hd,), dtype=dtype, device=gen.device),
            bv=torch.zeros((KV * hd,), dtype=dtype, device=gen.device),
        )
    return p


def _gqa_qkv(p, cfg, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _positions(B, S, device):
    return torch.arange(S, device=device).expand(B, S)


def gqa_full(p, cfg, x, *, causal=True, use_kernel=True):
    B, S, _ = x.shape
    _check_not_chunked(cfg, S)
    q, k, v = _gqa_qkv(p, cfg, x, _positions(B, S, x.device))
    out = _sdpa(q, k, v, causal=causal, use_kernel=use_kernel)
    return out.reshape(B, S, -1) @ p["wo"]


def gqa_prefill(p, cfg, x, cache_len, *, use_kernel=True):
    """Returns (out, cache) with cache capacity == cache_len ≥ S."""
    B, S, _ = x.shape
    _check_not_chunked(cfg, S)
    q, k, v = _gqa_qkv(p, cfg, x, _positions(B, S, x.device))
    out = _sdpa(q, k, v, causal=True, use_kernel=use_kernel)
    pad = cache_len - S
    cache = {
        "k": torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)),
        "v": torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)),
    }
    return out.reshape(B, S, -1) @ p["wo"], cache


def _masked_cache_update(cache, new, pos):
    """``new`` (B, 1, ...) written at per-row position ``pos`` by a masked
    select into a new cache, as the reference does (its caches are
    immutable; the caller's cache is left as it was)."""
    T = cache.shape[1]
    hit = torch.arange(T, device=cache.device)[None, :] == pos[:, None]  # (B, T)
    hit = hit.reshape(hit.shape + (1,) * (cache.dim() - 2))
    return torch.where(hit, new.to(cache.dtype), cache)


def gqa_decode(p, cfg, x, cache, pos):
    """x (B, 1, d); cache k/v (B, T, KV, hd); pos (B,) current lengths."""
    B = x.shape[0]
    q, k, v = _gqa_qkv(p, cfg, x, pos[:, None])
    k_cache = _masked_cache_update(cache["k"], k, pos)
    v_cache = _masked_cache_update(cache["v"], v, pos)
    out = _sdpa(q, k_cache, v_cache, causal=False, kv_len=pos + 1)
    return out.reshape(B, 1, -1) @ p["wo"], {"k": k_cache, "v": v_cache}

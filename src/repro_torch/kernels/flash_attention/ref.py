"""Plain PyTorch versions of flash attention: softmax attention with an
optional causal mask and GQA, f32 math — the counterparts of
``repro.kernels.flash_attention.ref.attention_ref`` / ``gqa_attention_ref``.

The kernel's wrapper runs these on CPU tensors; the tests and
``chip_smoke.py`` hold the kernel to them."""

from __future__ import annotations

import torch


def attention_plain(q, k, v, *, causal=True, scale=None):
    """q (bh, sq, dh), k/v (bh, skv, dh) → (bh, sq, dh) in q.dtype, f32 math
    (f64 for f64 inputs).

    The causal mask keeps rows ≥ columns (row i sees keys 0..i)."""
    sq, dh = q.shape[1], q.shape[2]
    skv = k.shape[1]
    if scale is None:
        scale = dh**-0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqd,bkd->bqk", q.to(ct), k.to(ct)) * scale
    if causal:
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.to(ct)).to(q.dtype)


def gqa_attention_plain(q, k, v, *, causal=True, scale=None):
    """q (b, hq, sq, dh), k/v (b, hkv, skv, dh) with hq % hkv == 0: each kv
    head serves ``hq // hkv`` consecutive q heads."""
    b, hq, sq, dh = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    out = attention_plain(
        q.reshape(b * hq, sq, dh),
        k.reshape(b * hq, -1, dh),
        v.reshape(b * hq, -1, dh),
        causal=causal,
        scale=scale,
    )
    return out.reshape(b, hq, sq, dh)

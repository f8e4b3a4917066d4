"""Plain PyTorch versions of flash attention: softmax attention with an
optional causal mask and GQA, f32 math — the counterparts of
``repro.kernels.flash_attention.ref.attention_ref`` / ``gqa_attention_ref``.

The kernel's wrapper runs these on CPU tensors; the tests and
``chip_smoke.py`` hold the kernel to them.  Beside them,
``attention_tf32_mirror`` / ``gqa_attention_tf32_mirror`` are the f32
tensor-core route's arithmetic (3xTF32 products, the kernel's tiles and
partials) in plain torch, for the tests."""

from __future__ import annotations

import torch

from ..tf32 import tf32_matmul


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


#: kv rows a tile, and features summed into one partial of S, on the f32
#: tensor-core route (``tf::BK``, ``tf::KG`` × 8 in the source)
TF32_KV_TILE = 32
TF32_S_PARTIAL = 32


def attention_tf32_mirror(q, k, v, *, causal=True, scale=None, passes=3):
    """The f32 tensor-core route's arithmetic in plain torch: q (bh, sq, dh),
    k/v (bh, skv, dh) f32 → (bh, sq, dh) f32.

    kv tiles of 32 rows in order; each tile's S = Q·Kᵀ as 3xTF32 partials
    over 32 features (``kernels.tf32.tf32_matmul``), summed in order in
    f32, then scaled; masked scores at −1e30, p = 0 and the rescale factor
    0 where they meet a masked value; the online softmax in f32; each
    tile's P·V (3xTF32) added to the rescaled running accumulator,
    O ← α·O + P·V; o = O·(1/l), 0 where l = 0.  ``passes=1`` is the same
    with one-pass TF32 products (the route never runs it)."""
    bh, sq, dh = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = dh**-0.5
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    neg = -1e30
    m = torch.full((bh, sq, 1), neg, dtype=f32, device=q.device)
    l = torch.zeros((bh, sq, 1), dtype=f32, device=q.device)
    o = torch.zeros((bh, sq, dh), dtype=f32, device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, skv, TF32_KV_TILE):
        kt, vt = k[:, k0 : k0 + TF32_KV_TILE], v[:, k0 : k0 + TF32_KV_TILE]
        s = None
        for f0 in range(0, dh, TF32_S_PARTIAL):
            part = tf32_matmul(q[..., f0 : f0 + TF32_S_PARTIAL],
                               kt[..., f0 : f0 + TF32_S_PARTIAL].transpose(1, 2), passes=passes)
            s = part if s is None else s + part
        s = s * scale
        if causal:
            cols = k0 + torch.arange(kt.shape[1], device=q.device)[None, :]
            s = torch.where(rows >= cols, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(s <= 0.5 * neg, 0.0, torch.exp(s - m_new))
        alpha = torch.where(m <= 0.5 * neg, 0.0, torch.exp(m - m_new))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + tf32_matmul(p, vt, passes=passes)
        m = m_new
    return o * torch.where(l == 0, 0.0, 1.0 / l)


def gqa_attention_tf32_mirror(q, k, v, *, causal=True, scale=None, passes=3):
    """:func:`attention_tf32_mirror` for q (b, hq, sq, dh), k/v (b, hkv, skv,
    dh): q head h reads kv head h // (hq // hkv)."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    out = attention_tf32_mirror(q.reshape(b * hq, sq, dh), k.reshape(b * hq, skv, dh),
                                v.reshape(b * hq, skv, dh), causal=causal, scale=scale,
                                passes=passes)
    return out.reshape(b, hq, sq, dh)

"""Attention: GQA (llama / qwen / command-r / whisper) and MLA (deepseek /
minicpm3) — the counterpart of ``repro.models.attention``.

Every variant has the reference's three entry modes:
  * full     — a whole sequence (training / encoder, bidirectional optional);
  * prefill  — a full pass that also returns the serving cache;
  * decode   — one new token against a fixed-capacity cache.

On CUDA tensors the GQA full and prefill passes and cross-attention run B4,
the hand-written flash attention kernel (``use_kernel=True``, the default;
the reference's ``use_flash``); a ``chunked_attention`` config takes B4 too,
since ``_sdpa_chunked`` is the same online-softmax algorithm and its chunk
only a tiling.  Decode, masked by the active lengths, runs the plain path,
as in the reference.  MLA is plain torch, as in the reference: its qk width
(r_kv + r_rope, 288 or 576) is past B4's head dims and its value width
differs from its key width.

On a mesh the heads are laid out by the sharding rules (``split_heads``:
KV heads over "model" where it divides them, else head_dim, else
replicated; MLA's heads and up-projections by the same rule, and its
attention over the heads where "model" divides them, else replicated),
decode's query follows its cache (``shard_q_like_cache``), a decode over
a cache whose sequence lies over "data" combines the ranks' slices by
log-sum-exp (``_attend_sequence_shards``), and B4 takes batch- or
head-sharded operands.  Where "model" does not
divide the KV heads, a whole sequence's attention splits the q heads over
"model" along their KV groups and gives each rank a copy of the KV head
its q heads read, or else gathers q, k and v over "model"
(``_whole_heads``).  Without a mesh every hint is the identity.
"""

from __future__ import annotations

import torch

from ..distributed.sharding import (
    axis_size,
    constrain,
    heads_spec,
    merge_heads,
    p_batch,
    reduce_partial,
    shard_q_like_cache,
    split_head_weight,
    split_heads,
)
from ..distributed.sharding import is_dtensor
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.shards import launch_on_shards
from . import layers
from .layers import apply_rope, at_least_f32, normal_init
from .layers import pad as zero_pad

NEG_INF = -1e30


def _whole_heads(q, k, v):
    """The layout of a whole sequence's attention on a mesh whose model
    axis m does not divide the KV heads: (q, k, v, the output's spec, or
    None to leave the output as it comes).

    Where the KV heads divide m and m divides the q heads (llama3.2-1b: 8
    KV and 32 q heads on m = 16), each rank's H/m q heads lie in one KV
    group: q goes to heads over "model", and each KV head, gathered over
    "model", is repeated m/KV times and the m copies split over "model",
    so that a rank attends its own q heads over the one KV head they read
    — 1/m of the scores on each rank.  Otherwise q, k and v are gathered
    over "model" and every rank attends over every head: a
    head_dim-sharded contraction would all-reduce the (S × T) scores, and
    B4 runs on batch and head shards only.  Decode keeps the cache's
    layout (one query row of scores)."""
    H, (B, T, KV, hd) = q.shape[2], k.shape
    m = axis_size("model")
    if not is_dtensor(k) or m == 1 or KV % m == 0:
        return q, k, v, None
    if m % KV == 0 and H % m == 0:
        spec = p_batch(None, "model", None)
        k, v = (constrain(constrain(t, p_batch(None, None, None))[:, :, :, None]
                          .expand(B, T, KV, m // KV, hd).reshape(B, T, m, hd), spec)
                for t in (k, v))
        return constrain(q, spec), k, v, spec
    if heads_spec(KV, hd)[3] is None:
        return q, k, v, None
    spec = p_batch(None, None, None)
    return (*(constrain(t, spec) for t in (q, k, v)), spec)


def _sdpa(q, k, v, *, causal, kv_len=None, use_kernel=True):
    """q (B,S,H,hd), k/v (B,T,KV,hd) → (B,S,H,hd). f32 softmax.

    kv_len: optional (B,) active lengths for decode masking.  Without it,
    ``use_kernel`` takes B4 (the plain flash version on CPU tensors)."""
    out_spec = None
    if kv_len is None:
        q, k, v, out_spec = _whole_heads(q, k, v)

    if use_kernel and kv_len is None:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal)
        return out.transpose(1, 2)
    if kv_len is not None and is_dtensor(k) and any(p.is_shard(1) for p in k.placements):
        out = _attend_sequence_shards(q, k, v, kv_len)
    elif is_dtensor(q) and not any(p.is_shard(3) for p in q.placements):
        # batch and head shards: each rank attends over its own, locally
        # (DTensor's einsum strategies differ between torch versions);
        # decode's head_dim shards take DTensor's path (a partial sum)
        out = _attend_on_shards(q, k, v, causal, kv_len)
    else:
        out = _sdpa_plain(q, k, v, causal, kv_len)
    if out_spec is not None:  # its gradient too, for the head views
        out = constrain(out, out_spec, grad=True)
    return out


def _attend_on_shards(q, k, v, causal, kv_len):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    operands, axes = [q, k, v], [{"batch": 0, "heads": 2}] * 3
    if kv_len is not None:
        dm = q.device_mesh
        lengths = kv_len if is_dtensor(kv_len) else DTensor.from_local(
            kv_len, dm, [Replicate()] * dm.ndim)
        pl = [Shard(0) if p == Shard(0) else Replicate() for p in q.placements]
        operands.append(lengths.redistribute(dm, pl))
        axes.append({"batch": 0})
    return launch_on_shards(lambda *t: _sdpa_plain(*t[:3], causal, t[3] if len(t) > 3 else None),
                            "attention", tuple(operands), tuple(axes), 0,
                            whole={"heads": [(0, 2), (1, 2)]})


def _attend_sequence_shards(q, k, v, kv_len):
    """Decode attention over a KV cache whose sequence is sharded over the
    data axes (``cache_shardings``' layout of a batch-1 long-context cache):
    each rank attends the query over its slice of the cache, and the
    slices' softmax statistics — the maximum, the sum of exponentials and
    the weighted values — are combined over those axes by the log-sum-exp
    rule, which is how GSPMD partitions the reference's softmax there.  The
    cache is never gathered.  The heads keep the cache's "model" layout
    (heads over "model", or replicated); a head_dim shard raises."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = k.device_mesh
    if any(p.is_shard(3) for p in k.placements) or k.placements != v.placements:
        raise ValueError(f"attention over sequence shards: cannot attend a cache laid out "
                         f"{tuple(k.placements)} / {tuple(v.placements)}")
    seq = [p.is_shard(1) for p in k.placements]
    heads = [p.is_shard(2) for p in k.placements]
    q = q.redistribute(dm, [Shard(2) if h else Replicate() for h in heads])
    lengths = kv_len.full_tensor() if is_dtensor(kv_len) else kv_len
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    B, S, H, hd = ql.shape
    T, KV = kl.shape[1], kl.shape[2]
    shard = 0
    for md, sharded in enumerate(seq):  # this rank's slice of the cache, mesh dims major first
        if sharded:
            shard = shard * dm.size(md) + dm.get_local_rank(md)
    pos = shard * T + torch.arange(T, device=kl.device)
    scores = torch.einsum("bskgh,btkh->bkgst", at_least_f32(ql.reshape(B, S, KV, H // KV, hd)),
                          at_least_f32(kl)) * hd**-0.5
    scores = torch.where((pos[None, :] < lengths[:, None])[:, None, None, None], scores, NEG_INF)
    m = scores.amax(dim=-1)  # (B, KV, G, S)
    p = torch.where(scores <= -1e29, 0.0, torch.exp(scores - m[..., None]))

    def combine(x, op):  # x (B, KV, ...): reduced over the sequence shards
        partial = [Partial(op) if sq else (Shard(1) if h else Replicate())
                   for sq, h in zip(seq, heads)]
        reduced = [Replicate() if sq else pl for sq, pl in zip(seq, partial)]
        return DTensor.from_local(x, dm, partial).redistribute(dm, reduced).to_local()

    m_all = combine(m, "max")
    alpha = torch.where(m <= -1e29, 0.0, torch.exp(m - m_all))
    l = combine(p.sum(dim=-1) * alpha, "sum")  # (B, KV, G, S)
    acc = combine(torch.einsum("bkgst,btkh->bkgsh", p * alpha[..., None], at_least_f32(vl)), "sum")
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(ql.dtype)
    return DTensor.from_local(out, dm, q.placements, shape=q.shape, stride=q.stride())


def _sdpa_plain(q, k, v, causal, kv_len):
    """The plain attention: f32 scores, masks, softmax, the value sum."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    group = H // KV
    qg = q.reshape(B, S, KV, group, hd)
    # a head_dim-sharded decode (DTensor's path) sums the scores over
    # "model" here: DTensor would otherwise scatter the pending sum over
    # heads that "model" does not divide, which the value product cannot fold
    scores = reduce_partial(at_least_f32(torch.einsum("bskgh,btkh->bkgst", qg, k)))
    scores = scores * (hd**-0.5)
    if causal and S > 1:
        mask = torch.arange(S, device=q.device)[:, None] >= torch.arange(T, device=q.device)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    if kv_len is not None:
        valid = torch.arange(T, device=q.device)[None, :] < kv_len[:, None]  # (B, T)
        scores = torch.where(valid[:, None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v).reshape(B, S, H, hd)


def _online_softmax_step(carry, s, vb, value_eq):
    """One kv chunk of the online softmax: s the masked f32 scores (…, q, t),
    vb the chunk's values; ``value_eq`` the einsum of P and vb."""
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(s <= -1e29, 0.0, p)
    alpha = torch.exp(m - m_new)
    alpha = torch.where(m <= -1e29, 0.0, alpha)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum(value_eq, p, vb)
    return m_new, l, acc


def _causal_block_mask(qi, ki, q_chunk, kv_chunk, device):
    rows = qi * q_chunk + torch.arange(q_chunk, device=device)[:, None]
    cols = ki * kv_chunk + torch.arange(kv_chunk, device=device)[None, :]
    return rows >= cols


def _sdpa_chunked(q, k, v, *, causal, q_chunk=1024, kv_chunk=1024, use_kernel=True):
    """Flash-style attention over (q, kv) chunks with an online softmax: the
    (S × T) score matrix is never formed.  On CUDA tensors with
    ``use_kernel`` this is B4 (the same algorithm, tiled by the kernel);
    otherwise the reference's plain double loop, f32 math."""
    if use_kernel and q.is_cuda:
        return _sdpa(q, k, v, causal=causal, use_kernel=True)
    q, k, v, out_spec = _whole_heads(q, k, v)
    if not is_dtensor(q):
        return _chunked_plain(q, k, v, causal, q_chunk, kv_chunk)
    # on a mesh each rank runs the loop over its batch and head shards, as
    # the plain attention does (DTensor's einsums would fold the sharded
    # batch and heads into one strided dimension)
    out = launch_on_shards(lambda *t: _chunked_plain(*t, causal, q_chunk, kv_chunk), "attention",
                           (q, k, v), ({"batch": 0, "heads": 2},) * 3, 0,
                           whole={"heads": [(0, 2), (1, 2)]})
    return out if out_spec is None else constrain(out, out_spec, grad=True)


def _chunked_plain(q, k, v, causal, q_chunk, kv_chunk):
    """``_sdpa_chunked``'s double loop on plain tensors."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    group = H // KV
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    assert S % q_chunk == 0 and T % kv_chunk == 0
    ct = torch.promote_types(q.dtype, torch.float32)
    qh = q.reshape(B, S, KV, group, hd) * hd**-0.5

    def one_q_chunk(qi, qb):  # qb (B, qc, KV, G, hd)
        qb = qb.to(ct)
        carry = (torch.full((B, KV, group, q_chunk), NEG_INF, dtype=ct, device=q.device),
                 torch.zeros((B, KV, group, q_chunk), dtype=ct, device=q.device),
                 torch.zeros((B, KV, group, q_chunk, hd), dtype=ct, device=q.device))
        for ki in range(T // kv_chunk):
            kb = k[:, ki * kv_chunk : (ki + 1) * kv_chunk].to(ct)  # (B, kc, KV, hd)
            vb = v[:, ki * kv_chunk : (ki + 1) * kv_chunk].to(ct)
            s = torch.einsum("bqkgh,btkh->bkgqt", qb, kb)
            if causal:
                s = torch.where(_causal_block_mask(qi, ki, q_chunk, kv_chunk, q.device), s, NEG_INF)
            carry = _online_softmax_step(carry, s, vb, "bkgqt,btkh->bkgqh")
        _, l, acc = carry
        l = torch.where(l == 0.0, 1.0, l)
        out = (acc / l[..., None]).to(q.dtype)  # (B, KV, G, qc, hd)
        return out.permute(0, 3, 1, 2, 4)  # (B, qc, KV, G, hd)

    # each q chunk rematerialised, as the reference's: the backward keeps
    # O(S·hd), not the chunks' (q × T) probabilities
    outs = [layers.remat(one_q_chunk, qi, qh[:, qi * q_chunk : (qi + 1) * q_chunk])
            for qi in range(S // q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


# ---------------------------------------------------------------- GQA --------


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
    q = split_heads(q, H, hd, KV)
    k = split_heads(k, KV, hd, KV)
    v = split_heads(v, KV, hd, KV)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _positions(B, S, device):
    return torch.arange(S, device=device).expand(B, S)


def _chunk_ok(cfg, S):
    c = min(cfg.attn_chunk, S)
    return S % c == 0


def _attend(cfg, q, k, v, S, causal, use_kernel):
    """The reference's choice: ``_sdpa_chunked`` for a chunked config whose
    length the chunk divides, else ``_sdpa``."""
    if cfg.chunked_attention and S > 1 and _chunk_ok(cfg, S):
        return _sdpa_chunked(q, k, v, causal=causal, q_chunk=cfg.attn_chunk,
                             kv_chunk=cfg.attn_chunk, use_kernel=use_kernel)
    return _sdpa(q, k, v, causal=causal, use_kernel=use_kernel)


def gqa_full(p, cfg, x, *, causal=True, use_kernel=True):
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, _positions(B, S, x.device))
    out = _attend(cfg, q, k, v, S, causal, use_kernel)
    return merge_heads(out) @ p["wo"]


def gqa_prefill(p, cfg, x, cache_len, *, use_kernel=True):
    """Returns (out, cache) with cache capacity == cache_len ≥ S."""
    B, S, _ = x.shape
    q, k, v = _gqa_qkv(p, cfg, x, _positions(B, S, x.device))
    out = _attend(cfg, q, k, v, S, True, use_kernel)
    pad = cache_len - S
    cache = {
        "k": zero_pad(k, (0, 0, 0, 0, 0, pad)),
        "v": zero_pad(v, (0, 0, 0, 0, 0, pad)),
    }
    return merge_heads(out) @ p["wo"], cache


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
    q = shard_q_like_cache(q, cfg.num_kv_heads)
    k_cache = _masked_cache_update(cache["k"], k, pos)
    v_cache = _masked_cache_update(cache["v"], v, pos)
    out = _sdpa(q, k_cache, v_cache, causal=False, kv_len=pos + 1)
    return merge_heads(out) @ p["wo"], {"k": k_cache, "v": v_cache}


def gqa_cross_init(gen, cfg, dtype):
    """Cross-attention (whisper decoder): kv from encoder states."""
    return gqa_init(gen, cfg, dtype)


def gqa_cross(p, cfg, x, enc, enc_cache=None, *, use_kernel=True):
    """x (B,S,d) queries; enc (B,T,d) encoder states (no causal mask): B4
    on CUDA tensors with ``use_kernel``.

    enc_cache: precomputed {k, v} to amortize projections during decode."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]) if not cfg.qkv_bias else (x @ p["wq"] + p["bq"])
    q = split_heads(q, H, hd, KV)
    if enc_cache is None:
        k = enc @ p["wk"]
        v = enc @ p["wv"]
        if cfg.qkv_bias:
            k, v = k + p["bk"], v + p["bv"]
        k = split_heads(k, KV, hd, KV)
        v = split_heads(v, KV, hd, KV)
    else:
        k, v = enc_cache["k"], enc_cache["v"]
    out = _sdpa(q, k, v, causal=False, use_kernel=use_kernel)
    return merge_heads(out) @ p["wo"], {"k": k, "v": v}


# ---------------------------------------------------------------- MLA --------


def mla_init(gen, cfg, dtype):
    d = cfg.d_model
    H = cfg.num_heads
    hd = cfg.resolved_head_dim  # nope (non-positional) head dim
    vhd = cfg.resolved_v_head_dim
    r_kv, r_q, r_rope = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim
    s = d**-0.5
    p = {
        "w_dkv": normal_init(gen, (d, r_kv), s, dtype),
        "w_kr": normal_init(gen, (d, r_rope), s, dtype),
        "w_uk": normal_init(gen, (r_kv, H * hd), r_kv**-0.5, dtype),
        "w_uv": normal_init(gen, (r_kv, H * vhd), r_kv**-0.5, dtype),
        "wo": normal_init(gen, (H * vhd, d), s, dtype),
        "kv_norm": torch.ones((r_kv,), dtype=dtype, device=gen.device),
    }
    if r_q:
        p["w_dq"] = normal_init(gen, (d, r_q), s, dtype)
        p["w_uq"] = normal_init(gen, (r_q, H * (hd + r_rope)), r_q**-0.5, dtype)
        p["q_norm"] = torch.ones((r_q,), dtype=dtype, device=gen.device)
    else:
        p["wq"] = normal_init(gen, (d, H * (hd + r_rope)), s, dtype)
    return p


def _rms(x, scale, eps=1e-5):
    """MLA's latent RMS norm, with its own eps (not the config's)."""
    x32 = at_least_f32(x)
    out = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (out * at_least_f32(scale)).to(x.dtype)


def _mla_q(p, cfg, x):
    B, S, _ = x.shape
    H, hd, r_rope = cfg.num_heads, cfg.resolved_head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        q = _rms(x @ p["w_dq"], p["q_norm"]) @ p["w_uq"]
    else:
        q = x @ p["wq"]
    q = split_heads(q, H, hd + r_rope, H)
    return q[..., :hd], q[..., hd:]  # (nope, rope) parts


def _mla_kv_latent(p, cfg, x, positions):
    """Compressed cache entries: c_kv (B,S,r_kv), k_rope (B,S,r_rope)."""
    c_kv = _rms(x @ p["w_dkv"], p["kv_norm"])
    k_rope = x @ p["w_kr"]
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _mla_latent_q(p, cfg, q_nope, q_rope, positions_q):
    """q_nope absorbed into the latent space (q_nope W_ukᵀ per head), and
    q_rope rotated."""
    H, hd = q_nope.shape[2], q_nope.shape[3]
    q_rope = apply_rope(q_rope, positions_q, cfg.rope_theta)
    w_uk = split_head_weight(p["w_uk"], H, hd)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)  # (B,S,H,r_kv)
    return constrain(q_lat, _mla_heads(H)), q_rope


def _mla_heads(H):
    """The layout of MLA's per-head latent activations (B, S, H, r): the
    heads over "model" where it divides them, else replicated — every rank
    then attends over every head, as ``_whole_heads`` does for GQA (a
    latent-sharded contraction would all-reduce the (S × T) scores)."""
    m = axis_size("model")
    return p_batch(None, "model" if m > 1 and H % m == 0 else None, None)


def _mla_out(p, cfg, lat):
    """The value sum in latent space (B,S,H,r_kv) expanded per head and
    projected out."""
    H = lat.shape[2]
    w_uv = split_head_weight(p["w_uv"], H, cfg.resolved_v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", lat, w_uv)
    return merge_heads(out) @ p["wo"]


def _mla_attend(p, cfg, q_nope, q_rope, positions_q, c_kv, k_rope, *, causal, kv_len=None):
    """Attention in latent space (the 'absorbed' MLA formulation):

    score_h(i,j) = (q_nope_i W_uk_hᵀ)·c_j + q_rope_i·k_rope_j
    out_h(i)     = Σ_j p_ij (c_j W_uv_h)  — expand after the value sum.
    """
    S, hd = q_nope.shape[1], q_nope.shape[3]
    r_rope = cfg.rope_head_dim
    q_lat, q_rope = _mla_latent_q(p, cfg, q_nope, q_rope, positions_q)

    scores = torch.einsum("bshr,btr->bhst", q_lat, c_kv)
    scores = scores + torch.einsum("bshr,btr->bhst", q_rope, k_rope)
    scores = at_least_f32(scores) * ((hd + r_rope) ** -0.5)

    T = c_kv.shape[1]
    dev = c_kv.device
    if causal and S > 1:
        mask = torch.arange(S, device=dev)[:, None] >= torch.arange(T, device=dev)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    if kv_len is not None:
        valid = torch.arange(T, device=dev)[None, :] < kv_len[:, None]
        scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)

    # (B,H,S,r_kv) in the scores' order, then the view: an einsum straight
    # to (B,S,H,r_kv) folds (s, h) with a head shard inside it
    lat_out = torch.einsum("bhst,btr->bhsr", probs, c_kv).transpose(1, 2)
    return _mla_out(p, cfg, constrain(lat_out, _mla_heads(lat_out.shape[2]), grad=True))


def _mla_attend_chunked(p, cfg, q_nope, q_rope, positions_q, c_kv, k_rope, *, chunk=1024):
    """Causal chunked (online-softmax) MLA attention in latent space; on a
    mesh on each rank's batch and head shards, as ``_sdpa_chunked``."""
    hd = q_nope.shape[3]
    chunk = min(chunk, q_nope.shape[1])
    q_lat, q_rope = _mla_latent_q(p, cfg, q_nope, q_rope, positions_q)
    scale = (hd + cfg.rope_head_dim) ** -0.5
    if not is_dtensor(q_lat):
        return _mla_out(p, cfg, _mla_chunked_plain(q_lat, q_rope, c_kv, k_rope, chunk, scale))
    lat = launch_on_shards(lambda *t: _mla_chunked_plain(*t, chunk, scale), "attention",
                           (q_lat, constrain(q_rope, _mla_heads(q_lat.shape[2])), c_kv, k_rope),
                           ({"batch": 0, "heads": 2},) * 2 + ({"batch": 0},) * 2, 0)
    return _mla_out(p, cfg, constrain(lat, _mla_heads(lat.shape[2]), grad=True))


def _mla_chunked_plain(q_lat, q_rope, c_kv, k_rope, chunk, scale):
    """``_mla_attend_chunked``'s double loop on plain tensors: the latent
    output (B, S, H, r_kv)."""
    B, S, H, r_kv = q_lat.shape
    assert S % chunk == 0
    ct = torch.promote_types(c_kv.dtype, torch.float32)
    dev = c_kv.device
    nq = S // chunk

    def one_q_chunk(qi, ql, qr):  # ql (B, chunk, H, r_kv), qr (B, chunk, H, r_rope)
        ql, qr = ql.to(ct), qr.to(ct)
        carry = (torch.full((B, H, chunk), NEG_INF, dtype=ct, device=dev),
                 torch.zeros((B, H, chunk), dtype=ct, device=dev),
                 torch.zeros((B, H, chunk, r_kv), dtype=ct, device=dev))
        for ki in range(nq):
            ck = c_kv[:, ki * chunk : (ki + 1) * chunk].to(ct)
            kr = k_rope[:, ki * chunk : (ki + 1) * chunk].to(ct)
            s = torch.einsum("bqhr,btr->bhqt", ql, ck) + torch.einsum("bqhr,btr->bhqt", qr, kr)
            s = torch.where(_causal_block_mask(qi, ki, chunk, chunk, dev), s * scale, NEG_INF)
            carry = _online_softmax_step(carry, s, ck, "bhqt,btr->bhqr")
        _, l, acc = carry
        l = torch.where(l == 0.0, 1.0, l)
        return (acc / l[..., None]).to(c_kv.dtype).transpose(1, 2)  # (B, chunk, H, r_kv)

    lats = [layers.remat(one_q_chunk, qi, q_lat[:, qi * chunk : (qi + 1) * chunk],
                         q_rope[:, qi * chunk : (qi + 1) * chunk]) for qi in range(nq)]
    return torch.cat(lats, dim=1)


def mla_full(p, cfg, x, *, causal=True):
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    q_nope, q_rope = _mla_q(p, cfg, x)
    c_kv, k_rope = _mla_kv_latent(p, cfg, x, positions)
    if cfg.chunked_attention and causal and S > 1 and _chunk_ok(cfg, S):
        return _mla_attend_chunked(p, cfg, q_nope, q_rope, positions, c_kv, k_rope,
                                   chunk=cfg.attn_chunk)
    return _mla_attend(p, cfg, q_nope, q_rope, positions, c_kv, k_rope, causal=causal)


def mla_prefill(p, cfg, x, cache_len):
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    q_nope, q_rope = _mla_q(p, cfg, x)
    c_kv, k_rope = _mla_kv_latent(p, cfg, x, positions)
    out = _mla_attend(p, cfg, q_nope, q_rope, positions, c_kv, k_rope, causal=True)
    pad = cache_len - S
    cache = {
        "c_kv": zero_pad(c_kv, (0, 0, 0, pad)),
        "k_rope": zero_pad(k_rope, (0, 0, 0, pad)),
    }
    return out, cache


def mla_decode(p, cfg, x, cache, pos):
    q_nope, q_rope = _mla_q(p, cfg, x)
    c_new, kr_new = _mla_kv_latent(p, cfg, x, pos[:, None])
    c_kv = _masked_cache_update(cache["c_kv"], c_new, pos)
    k_rope = _masked_cache_update(cache["k_rope"], kr_new, pos)
    out = _mla_attend(p, cfg, q_nope, q_rope, pos[:, None], c_kv, k_rope, causal=False,
                      kv_len=pos + 1)
    return out, {"c_kv": c_kv, "k_rope": k_rope}

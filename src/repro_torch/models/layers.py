"""Shared building blocks: norms, RoPE, MLPs, embeddings, init helpers —
the counterparts of ``repro.models.layers``.

Parameters are nested dicts of tensors with the reference's names and
shapes, so that ``repro_torch.convert.lm_params_from_jax`` carries the
reference's pytree over as it is.  Initialisers draw from an explicit
``torch.Generator``; they draw in f32 and then cast, as the reference does
(the values differ from the reference's ``jax.random`` draws).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import is_dtensor


def at_least_f32(x):
    """``x`` in f32, where the reference computes in f32; f64 stays f64, so
    that a forward on f64 parameters runs in f64 throughout (the witness
    that ``chip_smoke.py`` holds the f32 forwards to)."""
    return x if x.dtype == torch.float64 else x.float()


def normal_init(gen, shape, scale, dtype):
    """scale · N(0, 1) of ``shape``, drawn in f32 on ``gen``'s device, cast
    to ``dtype`` (scaled in place: one f32 copy at a time, which bounds the
    init's peak at the largest tables, 12.6 GB for command-r's embedding)."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def rmsnorm_init(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-5):
    x32 = at_least_f32(x)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * at_least_f32(params["scale"])).to(x.dtype)


def layernorm_init(d, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-5):
    x32 = at_least_f32(x)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * at_least_f32(params["scale"]) + at_least_f32(params["bias"])
    return out.to(x.dtype)


def make_norm(cfg):
    """(init, apply) of the config's norm."""
    if cfg.norm == "rmsnorm":
        return rmsnorm_init, lambda p, x: rmsnorm(p, x, cfg.norm_eps)
    return layernorm_init, lambda p, x: layernorm(p, x, cfg.norm_eps)


def pad(x, widths):
    """``F.pad(x, widths)`` (zeros); on a DTensor on each rank's shard, the
    padded dimensions unsharded (torch 2.11's DTensor cannot pad)."""
    if not is_dtensor(x):
        return F.pad(x, widths)
    from torch.distributed.tensor import DTensor

    shape = list(x.shape)
    for i in range(len(widths) // 2):
        dim = x.dim() - 1 - i
        if widths[2 * i] or widths[2 * i + 1]:
            if any(p.is_shard(dim) or p.is_partial() for p in x.placements):
                raise ValueError(f"pad: dimension {dim} of {tuple(x.placements)} is sharded")
            shape[dim] += widths[2 * i] + widths[2 * i + 1]
    local = F.pad(x.to_local(), widths)
    return DTensor.from_local(local.contiguous(), x.device_mesh, x.placements, shape=tuple(shape),
                              stride=contiguous_stride(shape))


def remat(fn, *args):
    """``fn(*args)`` rematerialised, the reference's ``jax.checkpoint``:
    under autograd only its inputs are kept, and the backward runs ``fn``
    again for the rest.  The models draw no random numbers (no dropout),
    so the recompute gives the forward's bits without the RNG state being
    saved.  With grad disabled (serving) it is the plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


# -- rotary position embedding ------------------------------------------------


def rope_freqs(head_dim, theta, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x, positions, theta):
    """x (..., seq, heads, head_dim); positions (..., seq) int."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = at_least_f32(x).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- MLPs ---------------------------------------------------------------------


def mlp_init(gen, d, f, cfg, dtype):
    scale = (2.0 / (d + f)) ** 0.5
    if cfg.activation == "swiglu":
        return {
            "w_gate": normal_init(gen, (d, f), scale, dtype),
            "w_in": normal_init(gen, (d, f), scale, dtype),
            "w_out": normal_init(gen, (f, d), scale, dtype),
        }
    return {
        "w_in": normal_init(gen, (d, f), scale, dtype),
        "b_in": torch.zeros((f,), dtype=dtype, device=gen.device),
        "w_out": normal_init(gen, (f, d), scale, dtype),
        "b_out": torch.zeros((d,), dtype=dtype, device=gen.device),
    }


def mlp_apply(params, x, cfg):
    if cfg.activation == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_in"])
        return h @ params["w_out"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")
    return h @ params["w_out"] + params["b_out"]


# -- embeddings ---------------------------------------------------------------


def embedding_init(gen, vocab, d, dtype):
    return {"table": normal_init(gen, (vocab, d), d**-0.5, dtype)}


def take_rows(table, idx):
    """``table[idx]`` (idx an integer tensor of any shape).  Its backward,
    ``index_put_`` with accumulate, sorts the indices on CUDA and sums each
    row's gradients in that order, so two backwards give the same bits
    (PyTorch lists it deterministic; ``torch.gather``'s backward, a
    scatter-add with atomics, is not) — the contract a resumed training run
    needs to end on an uninterrupted run's bits."""
    return table[idx]


def embed(params, tokens):
    table = params["table"]
    if is_dtensor(table):
        return _embed_on_shards(table, tokens)
    return take_rows(table, tokens)


def _embed_on_shards(table, tokens):
    """The lookup on a mesh, on local shards (DTensor's index strategies
    differ between torch versions, and torch 2.11's backward of a lookup
    with batch-sharded indices fails): the table replicated over the axes
    that shard the tokens' batch, its vocabulary rows sharded over others
    (the vocab-parallel lookup: a rank looks up the ids in its rows, zeros
    elsewhere, a pending sum over those axes — exact, one rank's row is
    the only non-zero)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dm = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, dm, [Replicate()] * dm.ndim)
    batch = [p == Shard(0) for p in tokens.placements]
    want = [Replicate() if b else (p if p == Shard(0) else Replicate())
            for b, p in zip(batch, table.placements)]
    if list(table.placements) != want:
        table = table.redistribute(dm, want)
    vocab = [p == Shard(0) for p in want]
    if any(v and not isinstance(p, Replicate) for v, p in zip(vocab, tokens.placements)):
        tokens = tokens.redistribute(dm, [Replicate() if v else p
                                          for v, p in zip(vocab, tokens.placements)])
    grad = [Partial() if b else p for b, p in zip(batch, want)]
    local = table.to_local(grad_placements=grad)
    ids = tokens.to_local()
    rows = local.shape[0]
    shard = 0
    for md, v in enumerate(vocab):  # this rank's block of rows, mesh dims major first
        if v:
            shard = shard * dm.size(md) + dm.get_local_rank(md)
    start = shard * -(-table.shape[0] // max(1, _vocab_shards(dm, vocab)))
    mine = (ids >= start) & (ids < start + rows)
    out = take_rows(local, (ids - start).clamp(0, rows - 1))
    out = torch.where(mine[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    placements = [Partial() if v else (Shard(0) if b else Replicate())
                  for v, b in zip(vocab, batch)]
    shape = tuple(tokens.shape) + (table.shape[1],)
    return DTensor.from_local(out.contiguous(), dm, placements, shape=shape,
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple:
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


def _vocab_shards(dm, vocab):
    n = 1
    for md, v in enumerate(vocab):
        if v:
            n *= dm.size(md)
    return n


def cross_entropy(logits, labels, vocab):
    """Mean token CE in f32 (logits may be bf16; f64 stays f64) over the
    padded logits, as the reference: the max is detached, and the gold
    logit is picked by a masked sum over the vocabulary (the reference's
    iota / where / sum, which stays shard-local under vocab sharding)."""
    logits32 = at_least_f32(logits)
    m = torch.amax(logits32, dim=-1, keepdim=True).detach()
    shifted = logits32 - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    idx = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(idx == labels[..., None], shifted, 0.0), dim=-1)
    return torch.mean(lse - gold)


# -- stacked layer parameters ---------------------------------------------------


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts with the same keys."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_index(tree, i):
    """Layer i of a tree of stacked tensors."""
    return tree_map(lambda x: x[i], tree)


def tree_unbind(tree, n):
    """The n layers of a tree of stacked tensors, as a list of trees of
    views: one ``unbind`` per leaf, whose backward stacks the layers'
    gradients once (``tree_index`` per layer would allocate a whole
    stack's gradient for every layer)."""
    if isinstance(tree, dict):
        parts = {k: tree_unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def tree_stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def stacked_init(n, make):
    """``make()`` called n times, its trees stacked on a new leading axis:
    the stacked tensors are allocated once and filled layer by layer, so
    the peak is the stack plus one layer."""
    first = make()
    out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)
    tree_map(lambda o, x: o[0].copy_(x), out, first)
    del first
    for i in range(1, n):
        tree_map(lambda o, x: o[i].copy_(x), out, make())
    return out

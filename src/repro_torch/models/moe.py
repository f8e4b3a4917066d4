"""Mixture-of-experts FFN with capacity-bounded token-choice top-k routing
— the counterpart of ``repro.models.moe``.

Tokens are routed within groups of ``group_size``: each token picks its
top-k experts by gate, and per (group, expert) the top-C of the tokens that
picked it (C the capacity) are gathered, run through the expert's SwiGLU,
weighted by their gates and summed back, as in the reference.  The two
halves are separate functions, so that a caller can hold the routing fixed
and run the rest at another precision (``chip_smoke.py``'s f64 witness):

* :func:`moe_route` — gates, top-k, the capacity, the per-expert top-C and
  the Switch load-balance loss; every top-k breaks ties as
  ``jax.lax.top_k`` does, the lower index first (a stable descending
  sort), so the routing is the reference's given the same gates;
* :func:`moe_dispatch` — gather, experts, combine, shared experts.

The combine differs from the reference's scatter-add on purpose (ROADMAP
Queue C): an atomic scatter sums in a different order on every run on the
card.  Here each token gathers its own ≤ k expert outputs through the
inverse of the selection map and adds them in a fixed order (its top-k
order), so two runs give the same bits; for the same reason the
dispatch gathers by indexing (``layers.take_rows``), whose backward sums
in sorted order, not with ``torch.gather``, whose backward scatter-adds
with atomics, so two training steps do too.  Slots that hold no member token
(fewer than C picked the expert) are masked, as the reference's weights of
0 make them.  On a mesh the block runs expert-parallel on local shards
(:func:`moe_apply_sharded`), routed and combined as on one device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import (
    all_gather,
    axis_size,
    batch_axes,
    current_mesh,
    is_dtensor,
    ordered_psum,
    shard_activations,
)
from .layers import at_least_f32, normal_init, take_rows


class Routing(NamedTuple):
    gates: torch.Tensor  # (g, gs, E) f32 softmax of the router
    topk_val: torch.Tensor  # (g, gs, k) each token's chosen gates, descending
    topk_idx: torch.Tensor  # (g, gs, k) their experts
    member: torch.Tensor  # (g, gs, E) the gate where chosen, else 0
    sel_val: torch.Tensor  # (g, E, C) per expert its top-C member gates (0: empty slot)
    sel_idx: torch.Tensor  # (g, E, C) their tokens within the group
    aux: torch.Tensor  # () the Switch load-balance loss


def moe_init(gen, cfg, dtype):
    d, f, E = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    s = (2.0 / (d + f)) ** 0.5
    p = {
        "router": normal_init(gen, (d, E), d**-0.5, torch.float32),
        "experts": {
            "w_gate": normal_init(gen, (E, d, f), s, dtype),
            "w_in": normal_init(gen, (E, d, f), s, dtype),
            "w_out": normal_init(gen, (E, f, d), s, dtype),
        },
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": normal_init(gen, (d, fs), s, dtype),
            "w_in": normal_init(gen, (d, fs), s, dtype),
            "w_out": normal_init(gen, (fs, d), s, dtype),
        }
    return p


def top_k(x, k):
    """(values, indices) of the k largest along the last dim, the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, gs):
    return max(int(cfg.capacity_factor * cfg.top_k * gs / cfg.num_experts), 1)


def route_gates(cfg, gates):
    """The routing of gates (g, gs, E): (topk_val, topk_idx, member,
    sel_val, sel_idx), the reference's lines on the same gates."""
    g, gs, E = gates.shape
    topk_val, topk_idx = top_k(gates, cfg.top_k)
    member = torch.zeros_like(gates).scatter(-1, topk_idx, topk_val)
    sel_val, sel_idx = top_k(member.transpose(1, 2), capacity(cfg, gs))
    return topk_val, topk_idx, member, sel_val, sel_idx


def _groups(x, group_size):
    B, S, d = x.shape
    T = B * S
    g = max(T // group_size, 1)
    return x.reshape(g, T // g, d)


def moe_route(p, cfg, x, *, group_size: int = 2048) -> Routing:
    """x (B, S, d) → the routing of its tokens in groups of ``group_size``;
    gates in f32 (f64 for f64 inputs), as the reference computes them."""
    tokens = _groups(x, group_size)
    gates = torch.softmax(at_least_f32(tokens) @ at_least_f32(p["router"]), dim=-1)
    topk_val, topk_idx, member, sel_val, sel_idx = route_gates(cfg, gates)
    importance = gates.mean(dim=(0, 1))  # (E,)
    load = (member > 0).to(gates.dtype).mean(dim=(0, 1))
    aux = cfg.num_experts * torch.sum(importance * load)
    return Routing(gates, topk_val, topk_idx, member, sel_val, sel_idx, aux)


def moe_dispatch(p, cfg, x, routing: Routing, *, group_size: int = 2048):
    """x (B, S, d) and its routing → (B, S, d): the selected tokens through
    their experts, each token's ≤ k weighted outputs summed in its top-k
    order, plus the shared experts."""
    B, S, d = x.shape
    tokens = _groups(x, group_size)
    g, gs, _ = tokens.shape
    E = cfg.num_experts
    sel_val, sel_idx = routing.sel_val, routing.sel_idx
    C = sel_idx.shape[-1]

    # the gather's backward adds up to k gradients into a token: in sorted
    # order (take_rows), not by torch.gather's atomic scatter-add
    rows = sel_idx + gs * torch.arange(g, device=x.device)[:, None, None]
    gathered = take_rows(tokens.reshape(g * gs, d), rows)
    w = p["experts"]
    h = F.silu(torch.einsum("gecd,edf->gecf", gathered, w["w_gate"])) * torch.einsum(
        "gecd,edf->gecf", gathered, w["w_in"])
    expert_out = torch.einsum("gecf,efd->gecd", h, w["w_out"]).reshape(g, E * C, d)

    # the inverse of the selection: slot_of[g, e, t] = the slot of token t
    # in expert e's top-C, or -1 (each expert's C tokens are distinct, so
    # the scatter writes every target at most once)
    valid = sel_val > 0.0
    slots = torch.arange(C, device=x.device).expand_as(sel_idx)
    slot_of = torch.full((g, E, gs), -1, dtype=torch.int64, device=x.device)
    slot_of.scatter_(-1, sel_idx, torch.where(valid, slots, -1))
    # each token's hits are among its top-k experts: gather them in that order
    slot = torch.gather(slot_of.transpose(1, 2), 2, routing.topk_idx)  # (g, gs, k)
    hit = slot >= 0
    flat = routing.topk_idx * C + slot.clamp(min=0)
    weight = torch.where(hit, routing.topk_val, 0.0).to(x.dtype)  # the reference's sel_val·mask
    out = None
    for j in range(flat.shape[-1]):
        part = torch.gather(expert_out, 1, flat[..., j : j + 1].expand(-1, -1, d))
        part = part * weight[..., j : j + 1]
        out = part if out is None else out + part
    out = out.reshape(B, S, d)
    if cfg.num_shared_experts:
        sh = p["shared"]
        hs = F.silu(x @ sh["w_gate"]) * (x @ sh["w_in"])
        out = out + hs @ sh["w_out"]
    return out


def moe_apply(p, cfg, x, *, group_size: int = 2048):
    """x (B, S, d) → (out (B, S, d), the load-balance aux loss); a DTensor
    ``x`` takes the expert-parallel path (:func:`moe_apply_sharded`)."""
    if is_dtensor(x):
        return moe_apply_sharded(p, cfg, x, group_size=group_size)
    routing = moe_route(p, cfg, x, group_size=group_size)
    return moe_dispatch(p, cfg, x, routing, group_size=group_size), routing.aux


# -- expert parallelism on a mesh ---------------------------------------------


class _GatherDim(torch.autograd.Function):
    """Every shard's ``x`` along mesh ``axes``, concatenated on ``dim`` in
    shard order; the backward keeps this shard's slice of the gradient
    (the consumer runs replicated over ``axes``, so each rank's gradient of
    the whole is already the whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.n = mesh, axes, dim, x.shape[dim]
        return torch.cat(all_gather(x, mesh, axes), dim=dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.shard_index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None


def _placements(dm, default, **by_axis):
    return [by_axis.get(name, default) for name in dm.mesh_dim_names]


def moe_apply_sharded(p, cfg, x, *, group_size: int = 2048):
    """The MoE block on a mesh, on local shards with explicit collectives
    (DTensor cannot dispatch the in-place scatter of the selection's
    inverse).  ``x`` is laid out (batch over the data axes, the rest
    replicated), as the block's hint leaves it; the experts lie over
    "model" (``_RULES``), each rank running its own on its own tokens.

    Every rank routes on the same bits as one device would: each computes
    the gates of its own tokens, and where the routing groups
    (``group_size`` tokens of the flattened batch) span data shards, the
    gates are all-gathered over the data axes (values only) and every rank
    routes all groups.  A rank then runs its experts on the selected
    tokens it holds (zero rows for the others'), the expert outputs are
    all-gathered over "model" in expert order, and each token sums its
    ≤ k hits in its top-k order — the single-device combine, no
    scatter-add.  The aux loss takes its global means from ordered sums
    over the data axes; its gradient flows through each rank's own rows.
    The shared experts run on the DTensor ``x``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = current_mesh()
    x = shard_activations(x, None, None)
    dm = x.device_mesh
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    dp_axes = tuple(a for a, pl in zip(dm.mesh_dim_names, x.placements)
                    if a in batch_axes() and pl == Shard(0))
    dp = mesh.num_shards(dp_axes) if dp_axes else 1
    m = axis_size("model")
    if E % m:
        raise ValueError(f"{E} experts do not divide over the model axis of {m}")
    E_loc = E // m
    e0 = (mesh.shard_index(("model",)) if m > 1 else 0) * E_loc

    T = B * S
    g = max(T // group_size, 1)
    gs = T // g
    T_loc = T // dp
    aligned = T_loc % gs == 0  # each group lies within one data shard
    base = (mesh.shard_index(dp_axes) * T_loc) if dp_axes and not aligned else 0

    # local views: the gating path's gradient is replicated over "model";
    # the expert path's is a partial sum (each rank runs its own experts)
    grad_x_exp = _placements(dm, Replicate(), model=Partial())
    grad_x_exp = [Shard(0) if a in dp_axes else pl for a, pl in zip(dm.mesh_dim_names, grad_x_exp)]
    x_gate = x.to_local().reshape(T_loc, d)
    x_exp = x.to_local(grad_placements=grad_x_exp).reshape(T_loc, d)
    data_partial = {a: Partial() for a in dp_axes}
    router = p["router"].redistribute(dm, _placements(dm, Replicate())).to_local(
        grad_placements=_placements(dm, Replicate(), **data_partial))
    experts = {}
    for name, w in p["experts"].items():
        experts[name] = w.redistribute(dm, _placements(dm, Replicate(), model=Shard(0))).to_local(
            grad_placements=_placements(dm, Replicate(), model=Shard(0), **data_partial))

    # gates of this rank's tokens; the routing of every group they are in
    gates = torch.softmax(at_least_f32(x_gate) @ at_least_f32(router), dim=-1)  # (T_loc, E)
    routed = gates.detach()
    if dp_axes and not aligned:
        routed = torch.cat(all_gather(routed, mesh, dp_axes), dim=0)
    g_r = routed.shape[0] // gs
    topk_val, topk_idx, member, sel_val, sel_idx = route_gates(cfg, routed.reshape(g_r, gs, E))
    mine = base + torch.arange(T_loc, device=x_gate.device)  # token ids in the routed groups

    # aux: the global means from ordered sums over the data axes
    my_member = member.reshape(g_r * gs, E)[mine]
    importance = gates.sum(dim=0) / T
    load = (my_member > 0).to(gates.dtype).sum(dim=0) / T
    if dp_axes:
        imp_all = ordered_psum(importance.detach(), mesh, dp_axes)
        load = ordered_psum(load, mesh, dp_axes)
    else:
        imp_all = importance.detach()
    aux_mine = E * torch.sum(importance * load)
    aux = aux_mine + (E * torch.sum(imp_all * load) - aux_mine).detach()
    # a DTensor, so that its gradient comes back as a plain tensor
    aux = DTensor.from_local(aux, dm, _placements(dm, Replicate()))

    # this rank's experts on the selected tokens it holds
    C = sel_idx.shape[-1]
    sel_loc = sel_idx[:, e0:e0 + E_loc]
    tok = sel_loc + gs * torch.arange(g_r, device=x_gate.device)[:, None, None] - base
    held = (tok >= 0) & (tok < T_loc)
    gathered = take_rows(x_exp, tok.clamp(0, T_loc - 1))  # (g_r, E_loc, C, d)
    gathered = torch.where(held[..., None], gathered, 0.0)
    h = F.silu(torch.einsum("gecd,edf->gecf", gathered, experts["w_gate"])) * torch.einsum(
        "gecd,edf->gecf", gathered, experts["w_in"])
    expert_out = torch.einsum("gecf,efd->gecd", h, experts["w_out"])
    if m > 1:
        expert_out = _GatherDim.apply(expert_out, mesh, ("model",), 1)
    expert_out = expert_out.reshape(g_r * E * C, d)

    # the combine: each of this rank's tokens sums its hits in top-k order
    valid = sel_val > 0.0
    slots = torch.arange(C, device=x_gate.device).expand_as(sel_idx)
    slot_of = torch.full((g_r, E, gs), -1, dtype=torch.int64, device=x_gate.device)
    slot_of.scatter_(-1, sel_idx, torch.where(valid, slots, -1))
    slot = torch.gather(slot_of.transpose(1, 2), 2, topk_idx).reshape(g_r * gs, k)[mine]
    my_topk = topk_idx.reshape(g_r * gs, k)[mine]
    hit = slot >= 0
    flat = (mine // gs)[:, None] * (E * C) + my_topk * C + slot.clamp(min=0)
    weight = torch.where(hit, torch.gather(gates, 1, my_topk), 0.0).to(x_gate.dtype)
    out = None
    for j in range(k):
        part = take_rows(expert_out, flat[:, j]) * weight[:, j:j + 1]
        out = part if out is None else out + part
    out = DTensor.from_local(out.reshape(x.to_local().shape), dm, x.placements,
                             shape=x.shape, stride=x.stride())
    if cfg.num_shared_experts:
        sh = p["shared"]
        hs = F.silu(x @ sh["w_gate"]) * (x @ sh["w_in"])
        out = out + hs @ sh["w_out"]
    return out, aux

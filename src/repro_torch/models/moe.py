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
0 make them.  The reference's sharding hints are the identity on one
device and are left out.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

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
    """x (B, S, d) → (out (B, S, d), the load-balance aux loss)."""
    routing = moe_route(p, cfg, x, group_size=group_size)
    return moe_dispatch(p, cfg, x, routing, group_size=group_size), routing.aux

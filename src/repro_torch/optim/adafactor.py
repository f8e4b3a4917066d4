"""Adafactor (Shazeer & Stern 2018) — the counterpart of
``repro.optim.adafactor``: factored second moments (row and column running
averages) for leaves of rank ≥ ``min_dim_factored``, a full second moment
for vectors and scalars, no first moment, the decay 1 − step^−0.8 and RMS
update clipping.  ``update`` donates its inputs (package docstring)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..tree import tree_leaves, tree_map


class AdafactorState(NamedTuple):
    step: torch.Tensor  # () int32
    vr: dict  # row second moments (or the full v for rank < 2)
    vc: dict  # column second moments (or a (1,) placeholder)


def _decay(step, d=0.8):
    return 1.0 - step ** (-d)


def adafactor(lr=1e-2, eps=1e-30, clip_threshold=1.0, min_dim_factored=2):
    sched = lr if callable(lr) else (lambda step: lr)

    def init(params):
        def zeros(shape, p):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vr(p):
            return zeros(p.shape[:-1] if p.dim() >= min_dim_factored else p.shape, p)

        def vc(p):
            return zeros(p.shape[:-2] + p.shape[-1:] if p.dim() >= min_dim_factored else (1,), p)

        leaves = tree_leaves(params)
        step = torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)
        return AdafactorState(step, tree_map(vr, params), tree_map(vc, params))

    def update(grads, state, params):
        step = state.step + 1
        stepf = step.to(torch.float32)
        beta2 = _decay(stepf)
        lr_t = sched(stepf)
        with torch.no_grad():
            for g, vr, vc, p in zip(tree_leaves(grads), tree_leaves(state.vr),
                                    tree_leaves(state.vc), tree_leaves(params)):
                g32 = g.to(torch.float32)
                g2 = g32 * g32 + eps
                if p.dim() >= min_dim_factored:
                    vr.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-1))
                    vc.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-2))
                    r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
                    upd = g32 / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :])
                else:
                    vr.mul_(beta2).add_((1 - beta2) * g2)
                    upd = g32 / torch.sqrt(vr)
                rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
                upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
                p.copy_(p.to(torch.float32) - lr_t * upd)
        return params, AdafactorState(step, state.vr, state.vc)

    return init, update

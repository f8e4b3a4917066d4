"""Adam / AdamW with the reference's mixed-precision state policy
(``repro.optim.adam``): moments in ``state_dtype`` (f32) of the
parameters' tree structure, bias corrections in f32, the step computed in
f32 and cast back to each parameter's dtype — so a bf16 parameter loses
an update smaller than half its ulp, as the reference's does (ROADMAP
Queue C).

``update`` donates its inputs (package docstring): ``mu`` / ``nu`` are
updated in place and every parameter is overwritten, a large leaf in
slices of its leading dim, which bounds a step's memory at the state plus
a few f32 temporaries of at most ``SLICE_ELEMS`` entries."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..tree import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32, on the parameters' device
    mu: dict
    nu: dict


def _schedule(lr):
    return lr if callable(lr) else (lambda step: lr)


def _init(params, state_dtype):
    leaves = tree_leaves(params)
    # zeros_like: a DTensor parameter's moments are DTensors of its layout
    mu = tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype), params)
    nu = tree_map(lambda p: torch.zeros_like(p, dtype=state_dtype), params)
    step = torch.zeros((), dtype=torch.int32, device=leaves[0].device if leaves else None)
    return AdamState(step, mu, nu)


#: leaves above this many entries are updated in slices of their leading
#: dim, so a step's f32 temporaries stay near 256 MB whatever the leaf
SLICE_ELEMS = 1 << 26


def _slices(n_rows, row_elems):
    rows = max(1, SLICE_ELEMS // max(row_elems, 1))
    return [(i, min(i + rows, n_rows)) for i in range(0, n_rows, rows)]


def _update_leaf(g, m, v, p, *, lr_t, c1, c2, b1, b2, eps, weight_decay, state_dtype):
    """One leaf (or one slice of a leaf) of the update, in place: the
    reference's arithmetic, operation for operation, on as few temporaries
    as that allows (each in-place op rounds as its out-of-place form)."""
    g32 = g.to(state_dtype, copy=True)
    m.mul_(b1).add_((1 - b1) * g32)
    v.mul_(b2).add_(g32.mul_(g32).mul_(1 - b2))
    del g32
    denom = torch.div(v, c2).sqrt_().add_(eps)  # √v̂ + ε
    step = torch.div(m, c1)  # m̂
    p32 = p.to(state_dtype)
    if weight_decay is None:
        step.mul_(lr_t).div_(denom)  # lr·m̂ / (√v̂ + ε)
    else:
        step.div_(denom).add_(weight_decay * p32).mul_(lr_t)  # lr·(m̂/(√v̂ + ε) + wd·p)
    p.copy_(step.sub_(p32).neg_())  # p − step, exactly


def _update(grads, state, params, *, sched, b1, b2, eps, weight_decay, state_dtype):
    step = state.step + 1
    stepf = step.to(torch.float32)
    lr_t = sched(stepf)
    c1 = 1.0 - b1**stepf
    c2 = 1.0 - b2**stepf
    kw = dict(lr_t=lr_t, c1=c1, c2=c2, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
              state_dtype=state_dtype)
    with torch.no_grad():
        for leaves in zip(tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
                          tree_leaves(params)):
            # the update is elementwise: a DTensor leaf updates its local
            # shard (the caller lays its gradient out as its parameter)
            g, m, v, p = (x.to_local() if hasattr(x, "to_local") else x for x in leaves)
            if p.dim() == 0 or p.numel() <= SLICE_ELEMS:
                _update_leaf(g, m, v, p, **kw)
                continue
            for a, b in _slices(p.shape[0], p[0].numel()):
                _update_leaf(g[a:b], m[a:b], v[a:b], p[a:b], **kw)
    return params, AdamState(step, state.mu, state.nu)


def adam(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, state_dtype=torch.float32):
    """Returns (init_fn, update_fn). ``lr`` may be a float or a schedule
    (a function of the f32 step, 1 at the first update)."""
    sched = _schedule(lr)

    def init(params):
        return _init(params, state_dtype)

    def update(grads, state, params):
        return _update(grads, state, params, sched=sched, b1=b1, b2=b2, eps=eps,
                       weight_decay=None, state_dtype=state_dtype)

    return init, update


def adamw(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, state_dtype=torch.float32):
    """Adam with decoupled weight decay: p − lr·(m̂/(√v̂ + ε) + wd·p)."""
    sched = _schedule(lr)

    def init(params):
        return _init(params, state_dtype)

    def update(grads, state, params):
        return _update(grads, state, params, sched=sched, b1=b1, b2=b2, eps=eps,
                       weight_decay=weight_decay, state_dtype=state_dtype)

    return init, update

"""One bundle per architecture family — the counterpart of
``repro.models.model``: init / loss / prefill / decode / init_cache and the
functions that make the train, prefill and serve steps, for every family
(dense, moe, encdec, ssm, hybrid).

The loss runs each family's plain paths (the reference's ``use_flash=False``
/ ``use_pallas=False``): B4 and B5 have no backward, and their wrappers
raise when asked to differentiate.  The sharding specs wait for ROADMAP
Queue A step 17 item 7.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..optim import adam, clip_by_global_norm
from ..tree import tree_leaves, tree_unflatten
from . import encdec, hybrid, ssm_lm, transformer


class ModelBundle(NamedTuple):
    cfg: ModelConfig
    init: Callable  # (generator, max_seq=…) -> params, on the generator's device
    loss: Callable  # (params, batch) -> scalar, on the plain paths
    prefill: Callable  # (params, batch, cache_len, use_kernels) -> (logits, cache)
    decode: Callable  # (params, token, cache, pos) -> (logits, cache)
    init_cache: Callable  # (params, batch_size, cache_len) -> cache


def build_model(cfg: ModelConfig) -> ModelBundle:
    fam = cfg.family
    if fam in ("dense", "moe"):
        return ModelBundle(
            cfg=cfg,
            init=lambda gen, **kw: transformer.init(cfg, gen),
            loss=lambda p, b: transformer.loss_fn(p, cfg, b),
            prefill=lambda p, b, cache_len, use_kernels=True: transformer.prefill(
                p, cfg, b["tokens"], cache_len, use_kernels=use_kernels
            ),
            decode=lambda p, tok, c, pos: transformer.decode_step(p, cfg, tok, c, pos),
            init_cache=lambda p, bs, cl: transformer.init_cache(p, cfg, bs, cl),
        )
    if fam == "encdec":
        return ModelBundle(
            cfg=cfg,
            init=lambda gen, max_seq=4096, **kw: encdec.init(cfg, gen, max_seq=max_seq),
            loss=lambda p, b: encdec.loss_fn(p, cfg, b),
            prefill=lambda p, b, cache_len, use_kernels=True: encdec.prefill(
                p, cfg, b["frames"], b["tokens"], cache_len, use_kernels=use_kernels
            ),
            decode=lambda p, tok, c, pos: encdec.decode_step(p, cfg, tok, c, pos),
            init_cache=lambda p, bs, cl: encdec.init_cache(p, cfg, bs, cl),
        )
    if fam == "ssm":
        return ModelBundle(
            cfg=cfg,
            init=lambda gen, **kw: ssm_lm.init(cfg, gen),
            loss=lambda p, b: ssm_lm.loss_fn(p, cfg, b),
            prefill=lambda p, b, cache_len, use_kernels=True: _ssm_prefill(
                cfg, p, b, use_kernels
            ),
            decode=lambda p, tok, c, pos: ssm_lm.decode_step(p, cfg, tok, c, pos),
            init_cache=lambda p, bs, cl: ssm_lm.init_cache(p, cfg, bs, cl),
        )
    if fam == "hybrid":
        return ModelBundle(
            cfg=cfg,
            init=lambda gen, **kw: hybrid.init(cfg, gen),
            loss=lambda p, b: hybrid.loss_fn(p, cfg, b),
            prefill=lambda p, b, cache_len, use_kernels=True: _hybrid_prefill(
                cfg, p, b, cache_len, use_kernels
            ),
            decode=lambda p, tok, c, pos: hybrid.decode_step(p, cfg, tok, c, pos),
            init_cache=lambda p, bs, cl: hybrid.init_cache(p, cfg, bs, cl),
        )
    raise ValueError(fam)


def _ssm_prefill(cfg, params, batch, use_kernels=True):
    """The last position's logits and a ZERO state, as the reference's
    ``_ssm_prefill`` returns (ROADMAP Queue C); a caller that decodes on
    steps decode over the prompt first."""
    logits = ssm_lm.forward(params, cfg, batch["tokens"], use_kernels=use_kernels)
    cache = ssm_lm.init_cache(params, cfg, batch["tokens"].shape[0], 0)
    return logits[:, -1], cache


def _hybrid_prefill(cfg, params, batch, cache_len, use_kernels=True):
    """The last position's logits and an EMPTY cache, as the reference's
    ``_hybrid_prefill`` returns (its serve loop therefore prefills by
    stepping decode over the prompt; ROADMAP Queue C)."""
    logits = hybrid.forward(params, cfg, batch["tokens"], use_kernels=use_kernels)
    cache = hybrid.init_cache(params, cfg, batch["tokens"].shape[0], cache_len)
    return logits[:, -1], cache


def loss_and_grads(bundle: ModelBundle, params, batch):
    """(loss, gradients): ``bundle.loss`` and its gradient with respect to
    every leaf of ``params`` (a tree of the params' structure, each leaf in
    its parameter's dtype, as ``jax.grad`` gives them; None for a leaf the
    loss does not reach).  The caller's tensors are not touched: autograd
    runs on detached aliases."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = bundle.loss(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_train_step(bundle: ModelBundle, *, lr=3e-4, grad_clip=1.0):
    """(train_step, init_opt): the reference's step — value and gradient
    of ``bundle.loss``, the gradients cast to bf16 where the config's
    ``grad_reduce_dtype`` says so, clipped to the global norm
    ``grad_clip``, one Adam update at ``lr`` (a float or a schedule).

    ``train_step(params, opt_state, batch)`` returns (params, opt_state,
    {"loss", "grad_norm"}) and donates params and opt_state, as the
    reference's jitted step does (``repro_torch.optim``): they are updated
    in place.  A leaf the loss does not reach gets a zero gradient, as
    ``jax.grad`` gives it."""
    init_opt, update = adam(lr)
    reduce_dtype = getattr(bundle.cfg, "grad_reduce_dtype", "float32")

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(bundle, params, batch)
        grads = tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                        for g, p in zip(tree_leaves(grads), tree_leaves(params))])
        if reduce_dtype == "bfloat16":
            # halve the DP gradient-reduction bytes; Adam still accumulates
            # its moments in f32
            grads = tree_unflatten(params, [g.to(torch.bfloat16) for g in tree_leaves(grads)])
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        params, opt_state = update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return train_step, init_opt


def make_prefill_step(bundle: ModelBundle, cache_len, *, use_kernels=True):
    def prefill_step(params, batch):
        logits, cache = bundle.prefill(params, batch, cache_len, use_kernels)
        return torch.argmax(logits, dim=-1), cache

    return prefill_step


def make_serve_step(bundle: ModelBundle):
    def serve_step(params, token, cache, pos):
        logits, cache = bundle.decode(params, token, cache, pos)
        return torch.argmax(logits, dim=-1), cache

    return serve_step

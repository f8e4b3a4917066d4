"""One bundle per architecture family — the counterpart of
``repro.models.model``: init / loss / prefill / decode / init_cache and the
functions that make the train, prefill and serve steps, for every family
(dense, moe, encdec, ssm, hybrid).

The loss runs each family's plain paths (the reference's ``use_flash=False``
/ ``use_pallas=False``): B4 and B5 have no backward, and their wrappers
raise when asked to differentiate.

On a mesh (``repro_torch.distributed``) the same functions run on
DTensors: ``stacked_paths`` tells the sharding rules which leading
dimensions are layer stacks, :func:`input_specs` / :func:`batch_shardings`
give each cell's inputs and their layouts, and the steps run under
:func:`mesh_context`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import (
    P,
    axis_size,
    batch_axes,
    gather_dim,
    is_dtensor,
    p_batch,
    params_for_use,
)
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
    stacked_paths: dict  # regex → leading layer-stacking dims (the sharding rules)


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
            stacked_paths={r"^(prefix_)?layers/": 1},
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
            stacked_paths={r"^(encoder|decoder)/": 1},
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
            stacked_paths={r"^layers/": 1},
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
            stacked_paths={r"^groups/": 2, r"^(tail|layers)/": 1},
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


# -- input specs (the dry-run's stand-ins and the batch layouts) -------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Meta tensors (shape and dtype, no storage: the reference's
    ``ShapeDtypeStruct``) for every model input of this cell.  Tokens are
    int64, the port's index dtype (the reference's are int32)."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": meta((B, S + 1 if shape.kind == "train" else S), torch.int64)}
        if cfg.family == "encdec":
            batch["frames"] = meta((B, cfg.encoder_seq, cfg.d_model), dt)
        return batch
    # decode: one token against a seq_len cache
    return {"token": meta((B,), torch.int64), "pos": meta((B,), torch.int64)}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig):
    """The specs of :func:`input_specs`: batch over the data axes where
    they divide it, else replicated."""
    dsz = 1
    for a in batch_axes():
        dsz *= axis_size(a)
    divisible = shape.global_batch % max(dsz, 1) == 0
    bspec = p_batch if divisible else (lambda *rest: P(None, *rest))
    if shape.kind in ("train", "prefill"):
        spec = {"tokens": bspec(None)}
        if cfg.family == "encdec":
            spec["frames"] = bspec(None, None)
        return spec
    return {"token": bspec(), "pos": bspec()}


@contextlib.contextmanager
def mesh_context(tree):
    """``implicit_replication()`` where ``tree`` holds a DTensor, else
    nothing.  The models make fresh plain tensors (positions, RoPE tables,
    masks, zeros); under a mesh these enter DTensor ops as replicated,
    which they are: every rank makes the same ones."""
    if not any(is_dtensor(x) for x in tree_leaves(tree)):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        yield


def loss_and_grads(bundle: ModelBundle, params, batch):
    """(loss, gradients): ``bundle.loss`` and its gradient with respect to
    every leaf of ``params`` (a tree of the params' structure, each leaf in
    its parameter's dtype, as ``jax.grad`` gives them; None for a leaf the
    loss does not reach).  The caller's tensors are not touched: autograd
    runs on detached aliases.  The layer stacks are gathered layer by
    layer inside each rematerialised body (``params_for_use``'s
    ``stacked_paths``), so the backward's recompute gathers them again,
    as the reference's remat does."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        loss = bundle.loss(params_for_use(tree_unflatten(params, live), bundle.stacked_paths),
                           batch)
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
        with mesh_context(params):
            loss, grads = loss_and_grads(bundle, params, batch)
            grads = tree_unflatten(params, [_like_param(g, p) for g, p in
                                            zip(tree_leaves(grads), tree_leaves(params))])
            if reduce_dtype == "bfloat16":
                # the reference's cast, to halve its DP reduction; under
                # DTensor that reduction ran inside the backward, in the
                # compute dtype (ROADMAP Queue C)
                grads = tree_unflatten(params, [g.to(torch.bfloat16) for g in tree_leaves(grads)])
            grads, gnorm = clip_by_global_norm(grads, grad_clip)
            params, opt_state = update(grads, opt_state, params)
        return params, opt_state, {"loss": _replicated(loss), "grad_norm": _replicated(gnorm)}

    return train_step, init_opt


def _like_param(g, p):
    """A leaf's gradient laid out as its parameter (zeros where the loss
    does not reach it): on a mesh, a DTensor gradient of another layout
    (a pending sum) is redistributed, which is the data-parallel
    reduction."""
    if g is None:
        return torch.zeros_like(p)
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _replicated(x):
    """A replicated DTensor scalar as the plain tensor every rank holds."""
    return x.full_tensor() if is_dtensor(x) else x


def greedy(logits):
    """The greedy token, argmax over the last (vocabulary) dimension.  On a
    mesh the vocabulary's shards are gathered first: DTensor's argmax over
    a sharded dimension takes each shard's offset from a tensor it reads
    on the host (``.item()``), which the dry-run's fake tensors cannot
    give."""
    return torch.argmax(gather_dim(logits, -1), dim=-1)


def make_prefill_step(bundle: ModelBundle, cache_len, *, use_kernels=True):
    def prefill_step(params, batch):
        with mesh_context(params):
            logits, cache = bundle.prefill(params_for_use(params), batch, cache_len, use_kernels)
            return greedy(logits), cache

    return prefill_step


def make_serve_step(bundle: ModelBundle):
    def serve_step(params, token, cache, pos):
        with mesh_context(params):
            logits, cache = bundle.decode(params_for_use(params), token, cache, pos)
            return greedy(logits), cache

    return serve_step

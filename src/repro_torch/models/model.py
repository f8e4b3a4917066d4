"""One bundle per architecture family — the counterpart of
``repro.models.model``, for serving: init / prefill / decode / init_cache
and the functions that make the prefill and serve steps, for every
family (dense, moe, encdec, ssm, hybrid).

The loss, the train step and the sharding specs wait for LM training
(ROADMAP Queue A step 17, items 5–7).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig
from . import encdec, hybrid, ssm_lm, transformer


class ModelBundle(NamedTuple):
    cfg: ModelConfig
    init: Callable  # (generator, max_seq=…) -> params, on the generator's device
    prefill: Callable  # (params, batch, cache_len, use_kernels) -> (logits, cache)
    decode: Callable  # (params, token, cache, pos) -> (logits, cache)
    init_cache: Callable  # (params, batch_size, cache_len) -> cache


def build_model(cfg: ModelConfig) -> ModelBundle:
    fam = cfg.family
    if fam in ("dense", "moe"):
        return ModelBundle(
            cfg=cfg,
            init=lambda gen, **kw: transformer.init(cfg, gen),
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

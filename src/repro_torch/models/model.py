"""One bundle per architecture family — the counterpart of
``repro.models.model``, for serving: init / prefill / decode / init_cache
and the prefill and serve step builders.

Only the hybrid family (zamba2) is ported; the others raise and name the
ROADMAP step that brings them.  The loss, the train step and the sharding
specs wait for LM training and multi-device (Queue A steps 17 and 16).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig, NotPortedError
from . import hybrid

_LATER = {
    "dense": "the dense transformer (ROADMAP Queue A step 17)",
    "moe": "the MoE transformer (ROADMAP Queue A step 17)",
    "ssm": "ssm_lm (ROADMAP Queue A step 17)",
    "encdec": "encdec (ROADMAP Queue A step 17)",
}


class ModelBundle(NamedTuple):
    cfg: ModelConfig
    init: Callable  # (generator) -> params, on the generator's device
    prefill: Callable  # (params, batch, cache_len, use_kernels) -> (logits, cache)
    decode: Callable  # (params, token, cache, pos) -> (logits, cache)
    init_cache: Callable  # (params, batch_size, cache_len) -> cache


def build_model(cfg: ModelConfig) -> ModelBundle:
    fam = cfg.family
    if fam == "hybrid":
        return ModelBundle(
            cfg=cfg,
            init=lambda gen: hybrid.init(cfg, gen),
            prefill=lambda p, b, cache_len, use_kernels=True: _hybrid_prefill(
                cfg, p, b, cache_len, use_kernels
            ),
            decode=lambda p, tok, c, pos: hybrid.decode_step(p, cfg, tok, c, pos),
            init_cache=lambda p, bs, cl: hybrid.init_cache(p, cfg, bs, cl),
        )
    if fam in _LATER:
        raise NotPortedError(f"the {fam} family is not ported yet: {_LATER[fam]}")
    raise ValueError(fam)


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

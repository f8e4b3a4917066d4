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


def at_least_f32(x):
    """``x`` in f32, where the reference computes in f32; f64 stays f64, so
    that a forward on f64 parameters runs in f64 throughout (the witness
    that ``chip_smoke.py`` holds the f32 forwards to)."""
    return x if x.dtype == torch.float64 else x.float()


def normal_init(gen, shape, scale, dtype):
    """scale · N(0, 1) of ``shape``, drawn in f32 on ``gen``'s device, cast
    to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (scale * x).to(dtype)


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


def embed(params, tokens):
    return params["table"][tokens]

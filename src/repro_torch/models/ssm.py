"""Mamba-2 block: conv1d frontend + gated SSD mixer — the counterpart of
``repro.models.ssm``.

The full and prefill passes run the chunked SSD scan: B5, the hand-written
kernel, on CUDA tensors (``use_kernel=True``, the default; the reference's
``use_pallas``), its plain chunked version otherwise.  Decode is the
O(1)-per-token recurrence carrying (conv window, SSD state) caches, in
plain torch as in the reference.  Every dtype cast is where the reference
has it: dt, A and D in f32, the f32 D-skip cast to the model dtype, the
f32 SSD state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.ops import ssd_decode_step, ssd_scan
from .layers import at_least_f32, normal_init


def mamba2_init(gen, cfg, dtype):
    d = cfg.d_model
    di = cfg.ssm_d_inner
    H = cfg.ssm_heads
    ds = cfg.ssm_state
    conv = cfg.ssm_conv
    dev = gen.device
    # in_proj → [z (gate) di, x di, B ds, C ds, dt H]
    in_width = 2 * di + 2 * ds + H
    return {
        "in_proj": normal_init(gen, (d, in_width), d**-0.5, dtype),
        "conv_w": normal_init(gen, (conv, di + 2 * ds), (1.0 / conv) ** 0.5, dtype),
        "conv_b": torch.zeros((di + 2 * ds,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32, device=dev)),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "out_norm": torch.ones((di,), dtype=dtype, device=dev),
        "out_proj": normal_init(gen, (di, d), di**-0.5, dtype),
    }


def _split_proj(cfg, proj):
    di, ds = cfg.ssm_d_inner, cfg.ssm_state
    z = proj[..., :di]
    xBC = proj[..., di : di + di + 2 * ds]
    dt = proj[..., di + di + 2 * ds :]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv over time. xBC (B, S, ch), w (conv, ch)."""
    conv = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, conv - 1, 0))
    out = sum(pad[:, i : i + S, :] * w[i][None, None, :] for i in range(conv))
    return F.silu(out + b)


def _gated_norm(y, z, scale, eps=1e-5):
    y32 = at_least_f32(y * F.silu(z))
    out = y32 * torch.rsqrt(torch.mean(y32 * y32, dim=-1, keepdim=True) + eps)
    return (out * at_least_f32(scale)).to(y.dtype)


def _mixer_inputs(p, cfg, xBC, dt_raw):
    """The conv output split into the scan's operands, as views: x
    (B,H,S,hd), dt (B,H,S) f32, A (H,) f32, B and C (B,S,ds)."""
    Bsz, S, _ = xBC.shape
    di, ds, H, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xs = xBC[..., :di]
    Bmat = xBC[..., di : di + ds]
    Cmat = xBC[..., di + ds :]
    dt = F.softplus(at_least_f32(dt_raw) + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])  # (H,) negative
    xh = xs.reshape(Bsz, S, H, hd).transpose(1, 2)  # (B,H,S,hd)
    return xh, dt.transpose(1, 2), A, Bmat, Cmat


def _mix(p, cfg, x, z, xh, dth, A, Bmat, Cmat, use_kernel):
    Bsz, S, _ = x.shape
    y = ssd_scan(xh, dth, A, Bmat, Cmat, chunk=min(cfg.ssm_chunk, S), use_kernel=use_kernel)
    y = (y + p["D"][None, :, None, None] * xh).to(x.dtype)  # f32 D-skip → model dtype
    y = y.transpose(1, 2).reshape(Bsz, S, cfg.ssm_d_inner)
    return _gated_norm(y, z, p["out_norm"]) @ p["out_proj"]


def mamba2_full(p, cfg, x, *, use_kernel=True):
    """x (B, S, d) → (B, S, d) via the chunked SSD scan."""
    z, xBC, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xh, dth, A, Bmat, Cmat = _mixer_inputs(p, cfg, xBC, dt_raw)
    return _mix(p, cfg, x, z, xh, dth, A, Bmat, Cmat, use_kernel)


def mamba2_init_cache(cfg, batch, dtype, device=None):
    di, ds, H, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di + 2 * ds), dtype=dtype, device=device),
        "ssd": torch.zeros((batch, H, hd, ds), dtype=torch.float32, device=device),
    }


def mamba2_prefill(p, cfg, x, *, use_kernel=True):
    """Full pass + terminal cache (conv tail + final SSD state), the final
    state in closed form from the chunked math, as in the reference."""
    S = x.shape[1]
    z, xBC, dt_raw = _split_proj(cfg, x @ p["in_proj"])
    xBC_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xh, dth, A, Bmat, Cmat = _mixer_inputs(p, cfg, xBC_conv, dt_raw)
    out = _mix(p, cfg, x, z, xh, dth, A, Bmat, Cmat, use_kernel)

    # terminal SSD state: h = Σ_j exp(Σ_{k>j} la_k)·Δ_j·(x_j ⊗ B_j)
    la = dth * A[None, :, None]  # (B,H,S)
    cum = torch.cumsum(la, dim=-1)
    coef = torch.exp(cum[..., -1:] - cum) * dth  # (B,H,S)
    state = torch.einsum("bhsd,bsn,bhs->bhdn", xh.float(), Bmat.float(), coef)
    cache = {
        "conv": xBC[:, S - (cfg.ssm_conv - 1) :, :],
        "ssd": state.float(),
    }
    return out, cache


def mamba2_decode(p, cfg, x, cache, pos):
    """x (B, 1, d) one token; cache from init_cache/prefill."""
    B = x.shape[0]
    di, ds, H, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim

    proj = x[:, 0] @ p["in_proj"]  # (B, width)
    z, xBC_new, dt_raw = _split_proj(cfg, proj)

    window = torch.cat([cache["conv"], xBC_new[:, None]], dim=1)  # (B, conv, ch)
    conv_out = torch.sum(window * p["conv_w"][None], dim=1) + p["conv_b"]
    xBC = F.silu(conv_out)

    xs = xBC[..., :di]
    Bt = xBC[..., di : di + ds]
    Ct = xBC[..., di + ds :]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])

    x_t = xs.reshape(B, H, hd)
    new_state, y = ssd_decode_step(cache["ssd"], x_t, dt, A, Bt, Ct)
    y = y + p["D"][None, :, None] * x_t
    y = y.reshape(B, 1, di).to(x.dtype)  # f32 state math → model dtype

    out = _gated_norm(y, z[:, None], p["out_norm"]) @ p["out_proj"]
    return out, {"conv": window[:, 1:], "ssd": new_state}

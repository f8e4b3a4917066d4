"""Gradient compression for bandwidth-bound all-reduces — the counterpart
of ``repro.optim.compression``: int8 block quantization (one f32 scale per
block of 256) with error feedback, the quantization residual carried by
the caller and added back before the next round.

``compressed_psum`` reduces over a world of :mod:`repro_torch.distributed`
(the reference's ``psum`` inside ``shard_map``): each rank all-gathers the
int8 payloads and scales — the bytes on the wire are the int8 stream — and
decompresses and adds them in shard order, so every rank holds the same
bits (the reference's sum of the decompressed values)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.sharding import all_gather, current_mesh

BLOCK = 256  # quantization block (per-block scale)


def int8_compress(x: torch.Tensor):
    """x (float) → (int8 payload (blocks, 256), per-block f32 scales,
    the original shape)."""
    flat = x.to(torch.float32).reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0], tuple(x.shape)


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return flat[:size].reshape(shape)


def compressed_psum(grad: torch.Tensor, axes, error: torch.Tensor, *, mesh=None):
    """Error-feedback int8 sum of ``grad`` over the mesh axes ``axes`` (a
    name or a tuple of names) of ``mesh`` (default: the ambient mesh of
    :func:`repro_torch.distributed.use_mesh`; without one, a world of one).

    Returns (the reduced gradient in grad's dtype, the new residual)."""
    corrected = grad.to(torch.float32) + error
    q, scale, shape = int8_compress(corrected)
    new_error = corrected - int8_decompress(q, scale, shape)
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        parts = [(q, scale)]
    else:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        parts = zip(all_gather(q, mesh, axes), all_gather(scale, mesh, axes))
    reduced = torch.zeros(shape, dtype=torch.float32, device=grad.device)
    for pq, ps in parts:
        reduced = reduced + int8_decompress(pq, ps, shape)
    return reduced.to(grad.dtype), new_error

"""SSD scan dispatch and the single-token decode step — the counterparts of
``repro.kernels.ssd_scan.ops``."""

from __future__ import annotations

import torch

from ...distributed.sharding import is_dtensor
from ..shards import launch_on_shards
from .ref import ssd_scan_chunked_ref
from .ssd_scan import ssd_scan_cuda


def ssd_scan(x, dt, A, B, C, *, chunk=128, use_kernel=True):
    """The chunked SSD scan: B5 on CUDA tensors (the plain chunked version on
    CPU tensors) when ``use_kernel``, else the plain chunked version on any
    device — the same math (the reference's ``use_pallas`` switch).  On
    DTensor operands both run on each rank's batch and head shards
    (``kernels.shards``): DTensor's own einsums would fold the sharded batch
    and heads into one strided dimension."""
    if use_kernel:
        return ssd_scan_cuda(x, dt, A, B, C, chunk=chunk)
    if any(is_dtensor(t) for t in (x, dt, A, B, C)):
        return launch_on_shards(
            ssd_scan_chunked_ref, "ssd_scan", (x, dt, A, B, C),
            ({"batch": 0, "heads": 1}, {"batch": 0, "heads": 1}, {"heads": 0}, {"batch": 0},
             {"batch": 0}), 0, chunk=chunk)
    return ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk)


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One token of the recurrence, for serving (plain torch: the reference
    has no kernel for it either).

    state (b,h,dh,ds) f32; x_t (b,h,dh); dt_t (b,h) f32; B_t/C_t (b,ds).
    Returns (new_state, y_t (b,h,dh)), both f32."""
    decay = torch.exp(dt_t * A[None, :])[..., None, None]  # (b,h,1,1)
    outer = torch.einsum("bhd,bs->bhds", x_t * dt_t[..., None], B_t.float())
    new_state = decay * state + outer
    y = torch.einsum("bhds,bs->bhd", new_state, C_t.float())
    return new_state, y

"""Flash attention's wrapper: :func:`flash_attention_cuda`, the counterpart of
``repro.kernels.flash_attention.flash_attention.flash_attention_pallas``
(``csrc/flash_attention.cu``, B4), bound with ctypes.

On CUDA tensors it launches the kernel; on CPU tensors it runs the plain
PyTorch version from :mod:`.ref`.  There is no fallback between the two: a
CUDA tensor launches the kernel or raises.

The module-level counter ``launches`` counts kernel launches, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import KernelLaunchError, load_library
from .ref import gqa_attention_plain

#: B4 launches since the last reset
launches = 0

#: the largest head dimension the kernel takes (its shared-memory tiles)
MAX_HEAD_DIM = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    global launches
    launches = 0


def _check_cuda_args(q, k, v):
    named = (("q", q), ("k", k), ("v", v))
    devices = {x.device for _, x in named}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(
            "flash_attention: q, k and v must lie on one CUDA device or all on "
            f"the CPU, got {sorted(map(str, devices))}"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            "flash_attention: q, k and v must share one dtype, float32 or "
            f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            "flash_attention: q (b, hq, sq, dh) and k, v (b, hkv, skv, dh) "
            f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, _, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(
            f"flash_attention: k / v {tuple(k.shape)} do not match q "
            f"{tuple(q.shape)} (same batch and head dim, hq a multiple of hkv)"
        )
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {dh} outside 1..{MAX_HEAD_DIM}")
    for name, x in named:
        if x.stride(3) != 1:
            raise ValueError(
                f"flash_attention: {name}'s head dim must be contiguous (stride "
                f"1), got strides {x.stride()}"
            )
    if max(b * hq, q.shape[2], k.shape[2]) >= 2**31 or -(-q.shape[2] // 64) > 65535:
        raise ValueError("flash_attention: b·hq and the lengths must fit the grid")


def flash_attention_cuda(q, k, v, *, causal=True, scale=None):
    """softmax(q·kᵀ·scale, causal mask rows ≥ cols)·v → (b, hq, sq, dh).

    q (b, hq, sq, dh), k/v (b, hkv, skv, dh) with hq a multiple of hkv (q
    head h reads kv head h // (hq // hkv)); float32 or bfloat16, each with
    a contiguous head dim (the other strides are free, so a transposed view
    needs no copy); f32 math, output in q's dtype.  ``scale`` defaults to
    dh^-½.  Any sq and skv: ragged tiles are masked in the kernel."""
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return gqa_attention_plain(q, k, v, causal=causal, scale=scale)
    _check_cuda_args(q, k, v)
    global launches
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if scale is None:
        scale = dh**-0.5
    # (b, sq, hq, dh) storage, returned as the (b, hq, sq, dh) view: the
    # model's next step folds the heads back into the features for free
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device).transpose(1, 2)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, out) for i in range(3))
    )
    lib = load_library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            _DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, dh, float(scale),
            int(bool(causal)), stream,
        )
    if err != 0:
        raise KernelLaunchError(
            f"flash_attention_fwd launch failed with cudaError {err} "
            f"(b={b}, hq={hq}, hkv={hkv}, sq={sq}, skv={skv}, dh={dh})"
        )
    launches += 1
    return out

"""Flash attention's wrapper: :func:`flash_attention_cuda`, the counterpart of
``repro.kernels.flash_attention.flash_attention.flash_attention_pallas``
(``csrc/flash_attention.cu``, B4), bound with ctypes.

On CUDA tensors it launches the kernel; on CPU tensors it runs the plain
PyTorch version from :mod:`.ref`.  There is no fallback between the two: a
CUDA tensor launches the kernel or raises.  The kernel has three routes,
which the C entry point chooses by shape, dtype and alignment alone and
:func:`b4_route` mirrors: bf16 on wgmma, f32 on 3xTF32 ``mma.sync``, and
the CUDA-core kernel for what neither takes.

The module-level counter ``launches`` counts kernel launches, so a run can
show that its main path went through the kernel; ``route_launches`` splits
them by route.
"""

from __future__ import annotations

import ctypes

import torch

from ...distributed.sharding import is_dtensor
from ..build import KernelLaunchError, load_library
from ..shards import launch_on_shards
from .ref import gqa_attention_plain

#: B4 launches since the last reset
launches = 0

#: the largest head dimension the kernel takes (its shared-memory tiles)
MAX_HEAD_DIM = 256

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the routes of :func:`b4_route`
TENSOR_CORES, TF32_TENSOR_CORES, CUDA_CORES = "tensor cores", "tf32 tensor cores", "cuda cores"

#: B4 launches since the last reset, by route
route_launches = {TENSOR_CORES: 0, TF32_TENSOR_CORES: 0, CUDA_CORES: 0}


def reset_launch_counts() -> None:
    global launches
    launches = 0
    for route in route_launches:
        route_launches[route] = 0


def _aligned(x) -> bool:
    """16-byte aligned base, and 16-byte aligned (batch, head, row) strides
    (a size-1 dim's stride is never stepped)."""
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and st * x.element_size() % 16 == 0)
        for n, st in zip(x.shape[:3], x.stride()[:3]))


def b4_route(q, k, v) -> str:
    """The kernel B4's entry point runs for these inputs (``tc::takes`` and
    ``tf::takes`` in the source): "tensor cores" for bf16 with a head dim
    that is a multiple of 16, kv rows, and 16-byte aligned bases and
    strides; "tf32 tensor cores" for f32 with a head dim that is a multiple
    of 8 and the same alignment; else "cuda cores"."""
    dh, skv = q.shape[-1], k.shape[2]
    aligned = all(_aligned(x) for x in (q, k, v))
    if q.dtype == torch.bfloat16 and dh % 16 == 0 and skv > 0 and aligned:
        return TENSOR_CORES
    if q.dtype == torch.float32 and dh % 8 == 0 and aligned:
        return TF32_TENSOR_CORES
    return CUDA_CORES


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
    dh^-½.  Any sq and skv: ragged tiles are masked in the kernel.

    Forward only: on CUDA inputs that require grad (with grad mode on) it
    raises rather than return an output autograd cannot differentiate.

    DTensor operands sharded over the batch or the heads (q's and k/v's
    heads each divisible by the shards, so a rank's q heads read its own
    kv heads), or replicated, launch on each rank's shard
    (``kernels.shards``); any other layout raises."""
    if any(is_dtensor(x) for x in (q, k, v)):
        return launch_on_shards(
            flash_attention_cuda, "flash_attention", (q, k, v),
            ({"batch": 0, "heads": 1},) * 3, 0, whole={"heads": [(0, 1), (1, 1)]},
            causal=causal, scale=scale)
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return gqa_attention_plain(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda has no backward kernel (ROADMAP Queue B follow-up 15): "
            "its output would carry no gradient to q, k or v.  Differentiate the plain "
            "path instead (use_kernel=False; every loss_fn does), or call it under "
            "torch.no_grad()"
        )
    _check_cuda_args(q, k, v)
    global launches
    route = b4_route(q, k, v)
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
    route_launches[route] += 1
    return out

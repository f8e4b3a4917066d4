"""The SSD scan's wrapper: :func:`ssd_scan_cuda`, the counterpart of
``repro.kernels.ssd_scan.ssd_scan.ssd_scan_pallas`` (``csrc/ssd_scan.cu``,
B5), bound with ctypes.

On CUDA tensors it launches the kernel; on CPU tensors it runs the plain
chunked version from :mod:`.ref`.  There is no fallback between the two: a
CUDA tensor launches the kernel or raises.

The module-level counter ``launches`` counts kernel launches, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import load_library
from .ref import ssd_scan_chunked_ref

#: B5 launches since the last reset
launches = 0

#: shared memory a block may use on an H100 (the kernel stages one chunk)
MAX_SHARED_BYTES = 232_448

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    global launches
    launches = 0


def shared_bytes(chunk: int, dh: int, ds: int) -> int:
    """The kernel's dynamic shared memory for one (batch, head) block: C,
    Bᵀ, x, the c×c decay matrix and the transposed state, rows padded to
    multiples of 8 plus one, and four per-step vectors (``Layout`` in the
    source)."""
    cp, dhp, dsp = (-(-n // 8) * 8 for n in (chunk, dh, ds))
    floats = cp * (dsp + 1) + dsp * (cp + 1) + cp * (dhp + 1) + cp * (cp + 1)
    floats += dsp * (dhp + 1) + 4 * cp
    return 4 * floats


def _check_cuda_args(x, dt, A, B, C, chunk):
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C))
    devices = {t.device for _, t in named}
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(
            "ssd_scan: x, dt, A, B and C must lie on one CUDA device or all on "
            f"the CPU, got {sorted(map(str, devices))}"
        )
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(
            "ssd_scan: x, B and C must share one dtype, float32 or bfloat16, "
            f"got {x.dtype}, {B.dtype}, {C.dtype}"
        )
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be float32, got {dt.dtype}, {A.dtype}")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (b, h, l, dh), got {tuple(x.shape)}")
    b, h, l, dh = x.shape
    ds = B.shape[-1]
    if dt.shape != (b, h, l) or A.shape != (h,) or B.shape != (b, l, ds) or C.shape != B.shape:
        raise ValueError(
            f"ssd_scan: dt (b,h,l), A (h,), B/C (b,l,ds) expected for x {tuple(x.shape)}, "
            f"got {tuple(dt.shape)}, {tuple(A.shape)}, {tuple(B.shape)}, {tuple(C.shape)}"
        )
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(
                f"ssd_scan: {name}'s last dim must be contiguous, got strides {t.stride()}"
            )
    if not A.is_contiguous():
        raise ValueError("ssd_scan: A must be contiguous")
    if chunk < 1 or l % chunk:
        raise ValueError(f"ssd_scan: length {l} is not a multiple of the chunk {chunk}")
    if shared_bytes(chunk, dh, ds) > MAX_SHARED_BYTES:
        raise ValueError(
            f"ssd_scan: chunk {chunk}, head dim {dh} and state {ds} need "
            f"{shared_bytes(chunk, dh, ds)} bytes of shared memory, more than "
            f"the {MAX_SHARED_BYTES} a block may use"
        )
    if b * h >= 2**31 or l >= 2**31:
        raise ValueError("ssd_scan: b·h and l must fit in int32")


def ssd_scan_cuda(x, dt, A, B, C, *, chunk=128):
    """Chunked SSD scan → y (b, h, l, dh) in x's dtype.

    x (b, h, l, dh) and B / C (b, l, ds) in float32 or bfloat16, each with a
    contiguous last dim (other strides free: the model passes views);
    dt (b, h, l) and A (h,) float32.  l must be a multiple of ``chunk``, as
    in the reference."""
    if all(t.device.type == "cpu" for t in (x, dt, A, B, C)):
        return ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk)
    _check_cuda_args(x, dt, A, B, C, chunk)
    global launches
    b, h, l, dh = x.shape
    ds = B.shape[-1]
    # (b, l, h, dh) storage, returned as the (b, h, l, dh) view: the model
    # folds the heads back into the features for free
    y = torch.empty((b, l, h, dh), dtype=x.dtype, device=x.device).transpose(1, 2)
    if y.numel() == 0:
        return y
    strides = (ctypes.c_longlong * 13)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2], *y.stride()[:3]
    )
    lib = load_library("ssd_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
            y.data_ptr(), strides, _DTYPE_CODES[x.dtype], b, h, l, dh, ds, int(chunk),
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ssd_scan_fwd launch failed with cudaError {err} "
            f"(b={b}, h={h}, l={l}, dh={dh}, ds={ds}, chunk={chunk})"
        )
    launches += 1
    return y

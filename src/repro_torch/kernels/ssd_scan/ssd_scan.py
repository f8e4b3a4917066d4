"""The SSD scan's wrapper: :func:`ssd_scan_cuda`, the counterpart of
``repro.kernels.ssd_scan.ssd_scan.ssd_scan_pallas`` (``csrc/ssd_scan.cu``,
B5), bound with ctypes.

On CUDA tensors it launches the kernel; on CPU tensors it runs the plain
chunked version from :mod:`.ref`.  There is no fallback between the two: a
CUDA tensor launches the kernel or raises.  The kernel has two routes, which
the C entry point chooses and :func:`b5_route` mirrors: bf16 inputs of the
right shapes and alignment go to the tensor cores, everything else to the
CUDA-core kernel.

The module-level counter ``launches`` counts kernel launches, so a run can
show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..build import KernelLaunchError, load_library
from .ref import ssd_scan_chunked_ref

#: B5 launches since the last reset
launches = 0

#: shared memory a block may use on an H100 (the kernel stages one chunk)
MAX_SHARED_BYTES = 232_448

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BF16_CUDA_CORES = 2  # the entry point's dtype code for bf16 held to the CUDA-core kernel


def _dtype_code(dtype, cuda_cores: bool) -> int:
    return _BF16_CUDA_CORES if cuda_cores and dtype == torch.bfloat16 else _DTYPE_CODES[dtype]


def reset_launch_counts() -> None:
    global launches
    launches = 0


def shared_bytes(chunk: int, dh: int, ds: int) -> int:
    """The CUDA-core kernel's dynamic shared memory for one (batch, head)
    block: C, Bᵀ, x, the c×c decay matrix and the transposed state, rows
    padded to multiples of 8 plus one, and four per-step vectors
    (``Layout`` in the source)."""
    cp, dhp, dsp = (-(-n // 8) * 8 for n in (chunk, dh, ds))
    floats = cp * (dsp + 1) + dsp * (cp + 1) + cp * (dhp + 1) + cp * (cp + 1)
    floats += dsp * (dhp + 1) + 4 * cp
    return 4 * floats


def tc_shared_bytes(chunk: int, dh: int, ds: int) -> int:
    """The tensor-core kernel's dynamic shared memory for one (batch, head)
    block (``tc::Layout`` in the source): x, B and C of a chunk in bf16 with
    rows padded by 8 elements, the transposed state in f32 and as its bf16
    high and low halves, eight per-step f32 vectors, the tile-to-tile
    decays and the diagonal tiles' decay tables; each region rounded up to
    16 bytes."""
    nrt = chunk // 16
    regions = (chunk * (dh + 8) * 2, chunk * (ds + 8) * 2, chunk * (ds + 8) * 2,
               ds * (dh + 8) * 2, ds * (dh + 8) * 2, ds * (dh + 8) * 4,
               *[chunk * 4] * 8, nrt * nrt * 4, chunk * 16 * 4)
    return sum(-(-r // 16) * 16 for r in regions)


def _aligned(t, dims: int) -> bool:
    """16-byte aligned base, and 16-byte aligned strides in the first
    ``dims`` dims (a size-1 dim's stride is never stepped)."""
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or st * t.element_size() % 16 == 0
        for n, st in zip(t.shape[:dims], t.stride()[:dims]))


def b5_route(x, dt, A, B, C, chunk) -> str:
    """The kernel B5's entry point runs for these inputs (``tc::takes`` in
    the source): "tensor cores" for bf16 with dh and ds multiples of 16 up
    to 128, a chunk that is a multiple of 16 and divides l, 16-byte aligned
    bases and strides of x, B and C, and a layout within a block's shared
    memory; else "cuda cores"."""
    dh, ds, l = x.shape[-1], B.shape[-1], x.shape[2]
    ok = (x.dtype == torch.bfloat16 and dh % 16 == 0 and ds % 16 == 0 and chunk % 16 == 0
          and dh <= 128 and ds <= 128 and l % chunk == 0
          and _aligned(x, 3) and _aligned(B, 2) and _aligned(C, 2)
          and tc_shared_bytes(chunk, dh, ds) <= MAX_SHARED_BYTES)
    return "tensor cores" if ok else "cuda cores"


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
    if b * h >= 2**31 or l >= 2**31:
        raise ValueError("ssd_scan: b·h and l must fit in int32")


def ssd_scan_cuda(x, dt, A, B, C, *, chunk=128, _cuda_cores=False):
    """Chunked SSD scan → y (b, h, l, dh) in x's dtype.

    x (b, h, l, dh) and B / C (b, l, ds) in float32 or bfloat16, each with a
    contiguous last dim (other strides free: the model passes views);
    dt (b, h, l) and A (h,) float32.  l must be a multiple of ``chunk``, as
    in the reference.  ``_cuda_cores`` (private: for comparing the two
    routes; the model never passes it) sends bf16 inputs to the CUDA-core
    kernel whatever :func:`b5_route` says."""
    if all(t.device.type == "cpu" for t in (x, dt, A, B, C)):
        return ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk)
    _check_cuda_args(x, dt, A, B, C, chunk)
    global launches
    b, h, l, dh = x.shape
    ds = B.shape[-1]
    route = "cuda cores" if _cuda_cores else b5_route(x, dt, A, B, C, chunk)
    if route == "cuda cores" and shared_bytes(chunk, dh, ds) > MAX_SHARED_BYTES:
        raise ValueError(
            f"ssd_scan: chunk {chunk}, head dim {dh} and state {ds} need "
            f"{shared_bytes(chunk, dh, ds)} bytes of shared memory on the CUDA-core "
            f"kernel, more than the {MAX_SHARED_BYTES} a block may use"
        )
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
            y.data_ptr(), strides, _dtype_code(x.dtype, _cuda_cores), b, h, l, dh, ds, int(chunk),
            stream,
        )
    if err != 0:
        raise KernelLaunchError(
            f"ssd_scan_fwd launch failed with cudaError {err} "
            f"(b={b}, h={h}, l={l}, dh={dh}, ds={ds}, chunk={chunk})"
        )
    launches += 1
    return y

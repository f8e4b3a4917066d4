"""The kernel-matrix kernels' wrappers, K never formed:

  * :func:`kernel_matmul_cuda` — (K(X1, X2) + σ²I_global) @ M, the
    counterpart of ``repro.kernels.kernel_matmul.kernel_matmul.kernel_matmul_pallas``
    (``csrc/kernel_matmul.cu``: B1 for a 2-D M, the same kernel's batch
    grid axis, B2, for a 3-D M);
  * :func:`fused_cg_step_cuda` — one fused mBCG iteration, the counterpart
    of ``fused_cg_step_pallas`` (``csrc/fused_cg_step.cu``, B3);
  * :func:`kernel_matmul_grad_cuda` — B1's vector-Jacobian product for its
    inputs and scalars (``csrc/kernel_matmul_grad.cu``, port-only: the
    reference differentiates its matmul with ``jax.vjp``), and
    :func:`kernel_matmul_grad_sym_cuda` the same for X1 = X2 = X in one
    launch;
  * :func:`kernel_matmul_grad_rows_cuda` — one launch of the gradient kernel
    for given weight factors A, B: the rows' gradient and the outputscale
    sum (a row panel of the symmetric VJP, the partitioned path's backward);
  * :class:`KernelMatmulFn` / :class:`SymKernelMatmulFn` — B1 as a
    ``torch.autograd.Function`` whose backward is the gradient kernel (the
    second for one X on both sides, as in training);
    :class:`BatchedKernelMatmulFn` the same for B2 (multi-output targets:
    one K, b right-hand sides), its backward one gradient-kernel launch
    over the batch folded into columns.

B1/B2 and B3 take ``compute_dtype``: "float32" (``precision="highest"``)
launches the 3xTF32 kernels above, "bfloat16" (``precision="mixed"``) their
bf16-operand counterparts (``csrc/kernel_matmul_bf16.cu``,
``csrc/fused_cg_step_bf16.cu``): the distance's inner product and the norms
on the tensor cores from bf16 X/ℓ, the kernel entries rounded to bf16, the
right-hand side rounded to bf16, the product summed in f32.  They read X/ℓ
as :func:`stage_bf16` lays it out (bf16, rows padded to a multiple of 16
features), so bf16 mode requires X to hold bf16 values (the mixed policy's
``prescale_inputs`` rounds it, and stages it once a solve).  The gradient
kernel is f32 only: the MLL's backward runs through the f32 operator, as
the reference's VJP does.

Each kernel is bound with ctypes.  On CUDA tensors a wrapper launches its
kernel; on CPU tensors it runs the plain PyTorch version from :mod:`.ref`.
There is no fallback between the two: a CUDA tensor launches the kernel
of the requested dtype or raises.

The module-level counters count kernel launches per kernel and dtype
(``launches``, ``batched_launches``, ``fused_launches``, ``grad_launches``
for f32; ``bf16_launches``, ``bf16_batched_launches``,
``bf16_fused_launches`` for bf16), so a run can show that its main path
went through the kernels it asked for.  ``panel_launches`` counts, among
the B1/B2/B3 launches of either dtype, those over a row panel (fewer rows
than columns: the partitioned path), so a run can show that a streamed
matmul or CG iteration took one launch per panel.  The counters are updated
under one lock, so they stay exact when several threads launch (the
serving session's query workers and its refresher);
:func:`thread_launch_counts` gives the calling thread's own counts since it
started, so a caller can attribute launches to one call.  While an
``obs.trace()`` is active, each launch also drops a ``launch`` marker on
it.
"""

from __future__ import annotations

import threading

import torch

from repro_torch import obs
from repro_torch.core.precision import is_reduced

from ..build import KernelLaunchError, load_library
from .ref import (
    KERNEL_TYPES,
    fused_cg_step_plain,
    kernel_matmul_grad_plain,
    kernel_matmul_grad_sym_plain,
    kernel_matmul_plain,
)

KERNEL_TYPE_CODES = {name: i for i, name in enumerate(KERNEL_TYPES)}

#: kernel launches with a 2-D M (B1) since the last reset
launches = 0
#: kernel launches with a 3-D M (B2) since the last reset
batched_launches = 0
#: fused CG step launches (B3) since the last reset
fused_launches = 0
#: gradient-kernel launches since the last reset
grad_launches = 0
#: bf16-operand launches of B1, B2 and B3 since the last reset
bf16_launches = 0
bf16_batched_launches = 0
bf16_fused_launches = 0
#: B1/B2/B3 launches (any dtype) whose rows are a panel of the columns
panel_launches = 0

#: the most features the gradient kernel takes
GRAD_MAX_D = 32
#: weight columns (the width of A and B) per gradient-kernel launch
GRAD_MAX_K = 128
#: rows per block of B3 and the gradient kernel (BN in their sources): one
#: partial sum per block, folded in a fixed order
ROW_BLOCK = 64


COUNTERS = ("launches", "batched_launches", "fused_launches", "grad_launches",
            "bf16_launches", "bf16_batched_launches", "bf16_fused_launches",
            "panel_launches")

_count_lock = threading.Lock()
_thread_counts = threading.local()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in COUNTERS:
            globals()[name] = 0


def launch_counts() -> dict[str, int]:
    """Every counter, read together under the counters' lock."""
    with _count_lock:
        return {name: globals()[name] for name in COUNTERS}


def thread_launch_counts() -> dict[str, int]:
    """The calling thread's launches by counter since the thread started
    (never reset): the difference around a call is what that call
    launched, whatever other threads launch meanwhile."""
    counts = _thread_counts.__dict__
    return {name: counts.get(name, 0) for name in COUNTERS}


def _count(name: str, k: int = 1, *, panel: bool = False) -> None:
    """Record k launches on counter ``name`` (and on ``panel_launches``
    for a row panel): atomically on the module counters, on this thread's
    counts, and as a marker on an active trace."""
    names = (name, "panel_launches") if panel else (name,)
    with _count_lock:
        for nm in names:
            globals()[nm] += k
    counts = _thread_counts.__dict__
    for nm in names:
        counts[nm] = counts.get(nm, 0) + k
    col = obs.active_trace()
    if col is not None:
        col.add_instant("launch", {"counter": name, "count": k, "panel": panel})


#: features of a staged bf16 X are padded to a multiple of this (one
#: tensor-core k-step)
BF16_FEATURE_ALIGN = 16


def stage_bf16(X: torch.Tensor) -> torch.Tensor:
    """X (n, d) as the bf16 kernels read it: bf16, contiguous, each row padded
    with zeros to a multiple of 16 features (zero features change no
    distance).  The kernels take X's values as bf16, so X must hold bf16
    values (the mixed policy's ``prescale_inputs`` rounds them); others are
    rounded here.

    The copy is made once per tensor: it is kept on X (on the tensor X is a
    row slice of, when it is one, so a row panel or band reads its rows of
    the base's copy) until X is written in place."""
    base = X._base if X._base is not None else X
    off = 0
    if base is not X:
        d = X.shape[-1]
        if (base.dim() != 2 or X.dim() != 2 or base.shape[1] != d or not base.is_contiguous()
                or not X.is_contiguous() or (X.storage_offset() - base.storage_offset()) % d):
            return _stage_copy(X)
        off = (X.storage_offset() - base.storage_offset()) // d
    # an inference tensor keeps no version counter
    version = -1 if base.is_inference() else base._version
    cached = getattr(base, "_bf16_stage", None)
    if cached is None or cached[0] != version or cached[1].device != base.device:
        cached = (version, _stage_copy(base))
        base._bf16_stage = cached
    return cached[1][off : off + X.shape[0]]


def _stage_copy(X: torch.Tensor) -> torch.Tensor:
    n, d = X.shape
    dp = -(-max(d, 1) // BF16_FEATURE_ALIGN) * BF16_FEATURE_ALIGN
    out = torch.zeros((n, dp), dtype=torch.bfloat16, device=X.device)
    with torch.no_grad():
        out[:, :d] = X
    return out


#: the bf16 kernels' chunks (``csrc/bf16_tile.cuh``: MAX_CHUNKS, chunk_tiles,
#: chunk_count): up to this many right-hand-side columns each row tile's
#: sum is taken in at most 16 chunks of at least 32 column tiles
_CHUNKED_WIDTH = 32


def _bf16_scratch(rows: int, cols: int, t: int, batch: int, device) -> torch.Tensor:
    """The bf16 kernels' scratch, laid out as ``csrc/bf16_tile.cuh``'s
    ``norms_floats`` and ``chunk_count`` say: the norms of the columns and
    rows (rounded up to 4 floats), then, at up to 32 columns, the chunks'
    sums (at least one chunk, batch, rows, t)."""
    norms = -(-(rows + cols) // 4) * 4
    chunks = 0
    if t <= _CHUNKED_WIDTH:
        tiles = -(-cols // 64)
        per_chunk = max(32, -(-tiles // 16))
        chunks = max(1, -(-tiles // per_chunk))
    return torch.empty(norms + chunks * batch * rows * t, dtype=torch.float32, device=device)


def _padded_width(t: int) -> int:
    """Columns of a bf16 right-hand side as the bf16 kernels read it: t
    rounded up to a multiple of 8, so that every row stages by 16-byte
    copies."""
    return -(-t // 8) * 8


def _device_scalar(v, device) -> torch.Tensor:
    # torch.full, not torch.tensor: a Python float becomes a device fill, not
    # a host-to-device copy that would synchronise the stream
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _check_tensors(fn: str, named):
    """All of ``named`` ((name, tensor) pairs) on one CUDA device, f32 and
    contiguous, or raise."""
    devices = {x.device for _, x in named}
    if len(devices) != 1 or named[0][1].device.type != "cuda":
        raise ValueError(
            f"{fn}: all tensors must lie on one CUDA device or all on the "
            f"CPU, got {sorted(map(str, devices))}"
        )
    for name, x in named:
        if x.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(
                f"{fn}: {name} must be contiguous (the kernel reads row-major "
                f"storage); pass {name}.contiguous()"
            )


def _check_cuda_args(X1, X2, M, kernel_type, row_offset):
    _check_tensors("kernel_matmul", [("X1", X1), ("X2", X2), ("M", M)])
    if X1.dim() != 2 or X2.dim() != 2 or X1.shape[1] != X2.shape[1]:
        raise ValueError(
            f"kernel_matmul: X1 (rows, d) and X2 (cols, d) expected, got "
            f"{tuple(X1.shape)} and {tuple(X2.shape)}"
        )
    if M.dim() not in (2, 3) or M.shape[-2] != X2.shape[0]:
        raise ValueError(
            f"kernel_matmul: M must be (cols, t) or (b, cols, t) with cols = "
            f"{X2.shape[0]}, got {tuple(M.shape)}"
        )
    if kernel_type not in KERNEL_TYPE_CODES:
        raise ValueError(f"kernel_matmul: unknown kernel_type {kernel_type!r}")
    if not 0 <= int(row_offset) < 2**31 - X1.shape[0]:
        raise ValueError(f"kernel_matmul: row_offset {row_offset} out of int32 range")
    if max(X1.shape[0], X2.shape[0], M.shape[-1]) >= 2**31:
        raise ValueError("kernel_matmul: dimensions must fit in int32")
    if M.dim() == 3 and M.shape[0] > 65535:
        raise ValueError("kernel_matmul: batch dim must be at most 65535")


def kernel_matmul_cuda(
    X1: torch.Tensor,
    X2: torch.Tensor,
    M: torch.Tensor,
    outputscale,
    sigma2,
    row_offset: int = 0,
    *,
    kernel_type: str = "rbf",
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """(K(X1, X2) + σ²·[row_offset + i == j]) @ M → (rows, t) or (b, rows, t).

    X1 (rows, d) and X2 (cols, d) are pre-divided by the lengthscale; M is
    (cols, t) or (b, cols, t); all f32 and contiguous.  ``outputscale`` and
    ``sigma2`` are floats or 0-d tensors; ``row_offset`` is the global row
    index of X1[0] (a host int).  The output is f32.  Under a bf16
    ``compute_dtype`` the bf16 kernel runs on X1 and X2 as
    :func:`stage_bf16` stages them (X must hold bf16 values) and on a bf16
    copy of M, its rows padded to a multiple of 8 columns (one cast here).
    """
    reduced = is_reduced(compute_dtype)
    if all(x.device.type == "cpu" for x in (X1, X2, M)):
        return kernel_matmul_plain(
            X1, X2, M, outputscale, sigma2, row_offset, kernel_type=kernel_type,
            compute_dtype=compute_dtype,
        )
    _check_cuda_args(X1, X2, M, kernel_type, row_offset)
    batched = M.dim() == 3
    rows, d = X1.shape
    cols, t = M.shape[-2:]
    batch = M.shape[0] if batched else 1
    out_shape = (batch, rows, t) if batched else (rows, t)
    out = torch.empty(out_shape, dtype=torch.float32, device=M.device)
    if rows == 0 or t == 0 or batch == 0:
        return out
    scal = torch.stack(
        [_device_scalar(outputscale, M.device), _device_scalar(sigma2, M.device)]
    )
    with torch.cuda.device(M.device):
        stream = torch.cuda.current_stream(M.device).cuda_stream
        if reduced:
            symbol = "kernel_matmul_bf16"
            tp = _padded_width(t)
            Mb = torch.nn.functional.pad(M.to(torch.bfloat16), (0, tp - t)).contiguous()
            X1b, X2b = stage_bf16(X1), stage_bf16(X2)
            scratch = _bf16_scratch(rows, cols, t, batch, M.device)
            err = load_library(symbol).kernel_matmul_bf16(
                X1b.data_ptr(), X2b.data_ptr(), Mb.data_ptr(), scal.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), rows, cols, X1b.shape[1], t, tp, batch,
                int(row_offset), KERNEL_TYPE_CODES[kernel_type], stream,
            )
        else:
            symbol = "kernel_matmul_f32"
            err = load_library("kernel_matmul").kernel_matmul_f32(
                X1.data_ptr(), X2.data_ptr(), M.data_ptr(), scal.data_ptr(),
                out.data_ptr(), rows, cols, d, t, batch, int(row_offset),
                KERNEL_TYPE_CODES[kernel_type], stream,
            )
    if err != 0:
        raise KernelLaunchError(
            f"{symbol} launch failed with cudaError {err} "
            f"(rows={rows}, cols={cols}, d={d}, t={t}, batch={batch})"
        )
    counter = ("bf16_" if reduced else "") + ("batched_launches" if batched else "launches")
    _count(counter, panel=rows < cols)
    return out


def _check_fused_args(X1, X2, state, cols_state, scalars, kernel_type, row_offset):
    named = [("Xs_rows", X1), ("Xs_cols", X2)]
    named += list(zip(("U", "R", "D", "V"), state))
    named += list(zip(("R_cols", "D_cols", "V_cols"), cols_state))
    named += list(zip(("alpha", "beta", "gamma"), scalars))
    _check_tensors("fused_cg_step", named)
    if X1.dim() != 2 or X2.dim() != 2 or X1.shape[1] != X2.shape[1]:
        raise ValueError(
            f"fused_cg_step: Xs_rows (rows, d) and Xs_cols (cols, d) expected, "
            f"got {tuple(X1.shape)} and {tuple(X2.shape)}"
        )
    if any(s.dim() != 2 or s.shape != scalars[0].shape for s in scalars):
        raise ValueError("fused_cg_step: alpha, beta and gamma must all be (b, t)")
    b, t = scalars[0].shape
    for names, xs, n in (("URDV", state, X1.shape[0]),
                         (("R_cols", "D_cols", "V_cols"), cols_state, X2.shape[0])):
        for name, x in zip(names, xs):
            if tuple(x.shape) != (b, n, t):
                raise ValueError(
                    f"fused_cg_step: {name} must be (b, n, t) = {(b, n, t)}, "
                    f"got {tuple(x.shape)}"
                )
    if kernel_type not in KERNEL_TYPE_CODES:
        raise ValueError(f"fused_cg_step: unknown kernel_type {kernel_type!r}")
    if not 0 <= int(row_offset) < 2**31 - X1.shape[0]:
        raise ValueError(f"fused_cg_step: row_offset {row_offset} out of int32 range")
    if max(X1.shape[0], X2.shape[0], t) >= 2**31 or b > 65535:
        raise ValueError("fused_cg_step: dimensions must fit in int32, batch in 65535")


def fused_cg_step_cuda(
    Xs_rows, Xs_cols, U, R, D, V, R_cols, D_cols, V_cols, alpha, beta, gamma,
    outputscale, sigma2, row_offset: int = 0, *, kernel_type: str = "rbf",
    compute_dtype: str = "float32",
):
    """One fused CG iteration (B3): (U′, R′, D′, V′, red).

    U, R, D, V are the (b, rows, t) state of this call's rows, R_cols,
    D_cols, V_cols the (b, cols, t) column state the product reads (the
    same tensors on a single device), α, β, γ the (b, t) pending step
    scalars; Xs_rows / Xs_cols are pre-divided by the lengthscale.  Returns
    new tensors — U′ = U + α∘D, R′ = R − α∘V, D′ = γ∘R′ + β∘D,
    V′ = (K + σ²·[row_offset+i = j])·D′ — and red (b, 4, t) =
    [D′ᵀV′; R′ᵀR′; R′ᵀV′; V′ᵀV′] over this call's rows.  The inputs are
    never written: the caller's next call takes the outputs (ping-pong).
    All f32 and contiguous; the scalars may be floats or 0-d tensors.  Under
    a bf16 ``compute_dtype`` the product takes bf16 operands (the bf16 B3;
    the state and the reductions stay f32; X as :func:`stage_bf16` stages
    it)."""
    reduced = is_reduced(compute_dtype)
    tensors = (Xs_rows, Xs_cols, U, R, D, V, R_cols, D_cols, V_cols, alpha, beta, gamma)
    if all(x.device.type == "cpu" for x in tensors):
        return fused_cg_step_plain(
            *tensors, outputscale, sigma2, row_offset, kernel_type=kernel_type,
            compute_dtype=compute_dtype,
        )
    _check_fused_args(
        Xs_rows, Xs_cols, (U, R, D, V), (R_cols, D_cols, V_cols), (alpha, beta, gamma),
        kernel_type, row_offset,
    )
    dev = U.device
    b, rows, t = U.shape
    cols, d = Xs_cols.shape
    Uo, Ro, Do, Vo = (torch.empty_like(U) for _ in range(4))
    red = torch.empty((b, 4, t), dtype=torch.float32, device=dev)
    if rows == 0 or t == 0 or b == 0:
        return Uo, Ro, Do, Vo, red.zero_()
    row_blocks = -(-rows // ROW_BLOCK)
    # scratch: the row blocks' partial reductions; in f32, then the columns'
    # D′ unless the column state is the rows' own (the kernel reads Do
    # then); in bf16, the columns' bf16 D′ in a buffer of its own
    shared = rows == cols and all(
        a.data_ptr() == c.data_ptr() for a, c in ((R, R_cols), (D, D_cols), (V, V_cols))
    )
    partial = torch.empty(
        row_blocks * b * 4 * t + (0 if shared or reduced else b * cols * t),
        dtype=torch.float32, device=dev,
    )
    abg = torch.stack([alpha, beta, gamma])
    scal = torch.stack([_device_scalar(outputscale, dev), _device_scalar(sigma2, dev)])
    if reduced:
        Xs_rows, Xs_cols = stage_bf16(Xs_rows), stage_bf16(Xs_cols)
        d = Xs_cols.shape[1]
    head = (Xs_rows.data_ptr(), Xs_cols.data_ptr(), U.data_ptr(), R.data_ptr(),
            D.data_ptr(), V.data_ptr(), R_cols.data_ptr(), D_cols.data_ptr(),
            V_cols.data_ptr(), abg.data_ptr(), scal.data_ptr(), Uo.data_ptr(),
            Ro.data_ptr(), Do.data_ptr(), Vo.data_ptr(), partial.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if reduced:
            symbol = "fused_cg_step_bf16"
            tp = _padded_width(t)
            Db = torch.empty((b, cols, tp), dtype=torch.bfloat16, device=dev)
            scratch = _bf16_scratch(rows, cols, t, b, dev)
            err = load_library(symbol).fused_cg_step_bf16(
                *head, Db.data_ptr(), scratch.data_ptr(), red.data_ptr(), rows, cols, d, t, tp,
                b, int(row_offset), KERNEL_TYPE_CODES[kernel_type], stream,
            )
        else:
            symbol = "fused_cg_step_f32"
            err = load_library("fused_cg_step").fused_cg_step_f32(
                *head, red.data_ptr(), rows, cols, d, t, b, int(row_offset),
                KERNEL_TYPE_CODES[kernel_type], stream,
            )
    if err != 0:
        raise KernelLaunchError(
            f"{symbol} launch failed with cudaError {err} "
            f"(rows={rows}, cols={cols}, d={d}, t={t}, batch={b})"
        )
    _count("bf16_fused_launches" if reduced else "fused_launches", panel=rows < cols)
    return Uo, Ro, Do, Vo, red


def _grad_launch(X1, X2, A, B, scal, kernel_type):
    """One call of the gradient kernel's entry point: G (rows, d) and
    Σᵢⱼ⟨Aᵢ, Bⱼ⟩f(rᵢⱼ²).  One launch for A, B up to GRAD_MAX_K columns wide,
    one more for each further GRAD_MAX_K."""
    rows, d = X1.shape
    cols, t = B.shape
    G = torch.empty((rows, d), dtype=torch.float32, device=X1.device)
    gsum = torch.empty((1,), dtype=torch.float32, device=X1.device)
    partial = torch.empty((-(-rows // ROW_BLOCK),), dtype=torch.float32, device=X1.device)
    lib = load_library("kernel_matmul_grad")
    with torch.cuda.device(X1.device):
        stream = torch.cuda.current_stream(X1.device).cuda_stream
        err = lib.kernel_matmul_grad_f32(
            X1.data_ptr(), X2.data_ptr(), A.data_ptr(), B.data_ptr(), scal.data_ptr(),
            G.data_ptr(), partial.data_ptr(), gsum.data_ptr(), rows, cols, d, t,
            KERNEL_TYPE_CODES[kernel_type], stream,
        )
    if err != 0:
        raise KernelLaunchError(
            f"kernel_matmul_grad_f32 launch failed with cudaError {err} "
            f"(rows={rows}, cols={cols}, d={d}, t={t})"
        )
    _count("grad_launches", -(-t // GRAD_MAX_K))
    return G, gsum[0]


def _sigma2_grad(M, C, row_offset: int = 0) -> torch.Tensor:
    """∂⟨C, σ²·[row_offset+i = j]·M⟩/∂σ² = Σᵢ ⟨Cᵢ, M_{row_offset+i}⟩: the
    O(n·t) trace term of the gradient, in torch."""
    off = int(row_offset)
    m = max(0, min(C.shape[0], M.shape[0] - off))
    return torch.sum(C[:m] * M[off : off + m])


def _check_grad_args(X1, X2, M, C, kernel_type):
    _check_tensors("kernel_matmul_grad", [("X1", X1), ("X2", X2), ("M", M), ("C", C)])
    if (X1.dim(), X2.dim(), M.dim(), C.dim()) != (2, 2, 2, 2) or X1.shape[1] != X2.shape[1] \
            or M.shape[0] != X2.shape[0] or C.shape != (X1.shape[0], M.shape[1]):
        raise ValueError(
            f"kernel_matmul_grad: X1 (rows, d), X2 (cols, d), M (cols, t), "
            f"C (rows, t) expected, got {tuple(X1.shape)}, {tuple(X2.shape)}, "
            f"{tuple(M.shape)}, {tuple(C.shape)}"
        )
    if X1.shape[1] > GRAD_MAX_D:
        raise ValueError(
            f"kernel_matmul_grad: d = {X1.shape[1]} > {GRAD_MAX_D}, the most "
            "features the gradient kernel takes"
        )
    if kernel_type not in KERNEL_TYPE_CODES:
        raise ValueError(f"kernel_matmul_grad: unknown kernel_type {kernel_type!r}")
    if max(X1.shape[0], X2.shape[0], 2 * M.shape[1]) >= 2**31:
        raise ValueError("kernel_matmul_grad: dimensions must fit in int32")


def kernel_matmul_grad_cuda(
    X1, X2, M, C, outputscale, sigma2, row_offset: int = 0, *,
    kernel_type: str = "rbf", need_cols: bool = True,
):
    """B1's vector-Jacobian product for a cotangent C (rows, t) of
    out = (K(X1, X2) + σ²·[row_offset+i = j])·M, M (cols, t):
    (∂/∂X1, ∂/∂X2, ∂/∂outputscale, ∂/∂σ²).

    On CUDA: one gradient-kernel launch for X1 and the outputscale, a
    second with the roles of (X1, C) and (X2, M) swapped for X2 (skipped,
    and ∂/∂X2 returned as None, when ``need_cols`` is False), and the σ²
    trace term in torch.  X1, X2 are pre-divided by the lengthscale."""
    if all(x.device.type == "cpu" for x in (X1, X2, M, C)):
        gX1, gX2, gs, gs2 = kernel_matmul_grad_plain(
            X1, X2, M, C, outputscale, sigma2, row_offset, kernel_type=kernel_type
        )
        return gX1, (gX2 if need_cols else None), gs, gs2
    _check_grad_args(X1, X2, M, C, kernel_type)
    dev = X1.device
    if X1.shape[0] == 0 or X2.shape[0] == 0 or M.shape[1] == 0:
        zero = torch.zeros((), device=dev)
        return (torch.zeros_like(X1), torch.zeros_like(X2) if need_cols else None,
                zero, _sigma2_grad(M, C, row_offset))
    scal = _device_scalar(outputscale, dev).reshape(1)
    gX1, gs = _grad_launch(X1, X2, C, M, scal, kernel_type)
    gX2 = _grad_launch(X2, X1, M, C, scal, kernel_type)[0] if need_cols else None
    return gX1, gX2, gs, _sigma2_grad(M, C, row_offset)


def kernel_matmul_grad_sym_cuda(X, M, C, outputscale, sigma2, *, kernel_type: str = "rbf"):
    """The vector-Jacobian product of (K(X, X) + σ²I)·M for a cotangent C
    (n, t), with one X on both sides: (∂/∂X, ∂/∂outputscale, ∂/∂σ²).

    On CUDA: ONE gradient-kernel launch with A = [C | M] and B = [M | C],
    whose weight ⟨Cᵢ, Mⱼ⟩ + ⟨Mᵢ, Cⱼ⟩ gives both sides' terms of every pair at
    once (its sum Σᵢⱼ wᵢⱼ fᵢⱼ is twice ∂/∂outputscale, f being symmetric),
    and the σ² trace term in torch.  X is pre-divided by the lengthscale."""
    if all(x.device.type == "cpu" for x in (X, M, C)):
        return kernel_matmul_grad_sym_plain(X, M, C, outputscale, sigma2, kernel_type=kernel_type)
    _check_grad_args(X, X, M, C, kernel_type)
    if X.shape[0] == 0 or M.shape[1] == 0:
        return torch.zeros_like(X), torch.zeros((), device=X.device), _sigma2_grad(M, C)
    scal = _device_scalar(outputscale, X.device).reshape(1)
    G, gsum = _grad_launch(X, X, torch.cat([C, M], dim=1), torch.cat([M, C], dim=1), scal,
                           kernel_type)
    return G, 0.5 * gsum, _sigma2_grad(M, C)


def kernel_matmul_grad_rows_cuda(X1, X2, A, B, outputscale, *, kernel_type: str = "rbf"):
    """One gradient-kernel launch for weight factors A (rows, k) and
    B (cols, k): (G, g) with Gᵢ = Σⱼ ⟨Aᵢ, Bⱼ⟩·∂k(x1ᵢ, x2ⱼ)/∂x1ᵢ (rows, d) and
    g = Σᵢⱼ ⟨Aᵢ, Bⱼ⟩·f(rᵢⱼ²), f the kernel over its outputscale.  X1, X2
    are pre-divided by the lengthscale.

    With X1 a row panel of X2 = X, A = [C | M] of the panel's rows and
    B = [M | C], G is those rows' whole gradient of ⟨C, K(X, X)·M⟩ and g
    twice their share of the outputscale's (the partitioned backward,
    :func:`repro_torch.kernels.kernel_matmul.ops.panel_vjp_prescaled`).
    On CPU tensors: the plain version (autograd of ⟨A, K(X1, X2)·B⟩)."""
    if all(x.device.type == "cpu" for x in (X1, X2, A, B)):
        gX1, _, gs, _ = kernel_matmul_grad_plain(
            X1, X2, B, A, outputscale, 0.0, kernel_type=kernel_type
        )
        return gX1, gs
    _check_grad_args(X1, X2, B, A, kernel_type)
    if X1.shape[0] == 0 or X2.shape[0] == 0 or A.shape[1] == 0:
        return torch.zeros_like(X1), torch.zeros((), device=X1.device)
    scal = _device_scalar(outputscale, X1.device).reshape(1)
    return _grad_launch(X1, X2, A, B, scal, kernel_type)


def _fold_batch(x: torch.Tensor) -> torch.Tensor:
    """(…, n, t) → (n, b·t): the leading dims folded into columns,
    batch-major (a 2-D x comes back as it is)."""
    n, t = x.shape[-2:]
    return x.reshape(-1, n, t).permute(1, 0, 2).reshape(n, -1)


class BatchedKernelMatmulFn(torch.autograd.Function):
    """(K(X1, X2) + σ²·[row_offset+i = j])·M for a batched M (b, cols, t) —
    B2, one K shared by b right-hand sides (the multi-output engine) —
    differentiable in X1, X2, M, the outputscale and σ².

    Forward: one B2 launch.  Backward: K is shared, so the hyperparameter
    gradient is the sum over the batch: M and the cotangent folded from
    (b, n, t) to (n, b·t) go through the 2-D vector-Jacobian product — one
    gradient-kernel launch when ``symmetric`` (X1 is X2 and row_offset is
    0, :func:`kernel_matmul_grad_sym_cuda`), else
    :func:`kernel_matmul_grad_cuda` — and, only where M needs a gradient,
    B2 on the cotangent with X1 and X2 swapped plus σ² on the shifted rows.
    On CPU tensors both run the plain versions."""

    @staticmethod
    def forward(ctx, X1, X2, M, outputscale, sigma2, row_offset, kernel_type, symmetric):
        ctx.save_for_backward(X1, X2, M, outputscale, sigma2)
        ctx.row_offset, ctx.kernel_type, ctx.symmetric = int(row_offset), kernel_type, symmetric
        return kernel_matmul_cuda(
            X1, X2, M, outputscale, sigma2, row_offset, kernel_type=kernel_type
        )

    @staticmethod
    def backward(ctx, C):
        X1, X2, M, s, s2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        off, kt = ctx.row_offset, ctx.kernel_type
        C = C.contiguous()
        gX1 = gX2 = gM = gs = gs2 = None
        if need[0] or need[1] or need[3] or need[4]:
            M2, C2 = _fold_batch(M), _fold_batch(C)
            if ctx.symmetric:
                # one tensor on both sides: its whole gradient goes to X1
                gX1, gs, gs2 = kernel_matmul_grad_sym_cuda(X1, M2, C2, s, s2, kernel_type=kt)
            else:
                gX1, gX2, gs, gs2 = kernel_matmul_grad_cuda(
                    X1, X2, M2, C2, s, s2, off, kernel_type=kt, need_cols=need[1]
                )
            gs, gs2 = gs.reshape(s.shape), gs2.reshape(s2.shape)
        if need[2]:
            gM = kernel_matmul_cuda(X2, X1, C, s, 0.0, kernel_type=kt)
            m = max(0, min(C.shape[-2], M.shape[-2] - off))
            gM[:, off : off + m] += s2 * C[:, :m]
        return gX1, gX2, gM, gs, gs2, None, None, None


class KernelMatmulFn(torch.autograd.Function):
    """(K(X1, X2) + σ²·[row_offset+i = j])·M for a 2-D M, differentiable in
    X1, X2, M, the outputscale and σ².

    Forward: one B1 launch (:func:`kernel_matmul_cuda`).  Backward: the
    gradient kernel for X1 / X2 / the outputscale and the σ² trace term
    (:func:`kernel_matmul_grad_cuda`), and — only where M needs a gradient —
    B1 with X1 and X2 swapped plus σ² on the shifted rows.  On CPU tensors
    both run the plain versions."""

    @staticmethod
    def forward(ctx, X1, X2, M, outputscale, sigma2, row_offset, kernel_type):
        ctx.save_for_backward(X1, X2, M, outputscale, sigma2)
        ctx.row_offset, ctx.kernel_type = int(row_offset), kernel_type
        return kernel_matmul_cuda(
            X1, X2, M, outputscale, sigma2, row_offset, kernel_type=kernel_type
        )

    @staticmethod
    def backward(ctx, C):
        X1, X2, M, s, s2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        off, kt = ctx.row_offset, ctx.kernel_type
        C = C.contiguous()
        gX1 = gX2 = gM = gs = gs2 = None
        if need[0] or need[1] or need[3] or need[4]:
            gX1, gX2, gs, gs2 = kernel_matmul_grad_cuda(
                X1, X2, M, C, s, s2, off, kernel_type=kt, need_cols=need[1]
            )
            gs, gs2 = gs.reshape(s.shape), gs2.reshape(s2.shape)
        if need[2]:
            gM = kernel_matmul_cuda(X2, X1, C, s, 0.0, kernel_type=kt)
            m = max(0, min(C.shape[0], M.shape[0] - off))
            gM[off : off + m] += s2 * C[:m]
        return gX1, gX2, gM, gs, gs2, None, None


class SymKernelMatmulFn(torch.autograd.Function):
    """(K(X, X) + σ²I)·M for a 2-D M and one X on both sides (training),
    differentiable in X, M, the outputscale and σ².

    Forward: one B1 launch.  Backward: one gradient-kernel launch for X and
    the outputscale and the σ² trace term
    (:func:`kernel_matmul_grad_sym_cuda`), and — only where M needs a
    gradient — B1 on C (K̂ is symmetric).  On CPU tensors both run the plain
    versions."""

    @staticmethod
    def forward(ctx, X, M, outputscale, sigma2, kernel_type):
        ctx.save_for_backward(X, M, outputscale, sigma2)
        ctx.kernel_type = kernel_type
        return kernel_matmul_cuda(X, X, M, outputscale, sigma2, kernel_type=kernel_type)

    @staticmethod
    def backward(ctx, C):
        X, M, s, s2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        kt = ctx.kernel_type
        C = C.contiguous()
        gX = gM = gs = gs2 = None
        if need[0] or need[2] or need[3]:
            gX, gs, gs2 = kernel_matmul_grad_sym_cuda(X, M, C, s, s2, kernel_type=kt)
            gs, gs2 = gs.reshape(s.shape), gs2.reshape(s2.shape)
        if need[1]:
            gM = kernel_matmul_cuda(X, X, C, s, s2, kernel_type=kt)
        return gX, gM, gs, gs2, None

"""The BBMM precision policy (counterpart of ``repro.core.precision``).

BBMM's cost is the repeated kernel matmul inside mBCG, so the one precision
decision that matters is the dtype of the kernel tiles and the tile × RHS
products.  Everything else — CG vector updates, inner products, the σ²
diagonal, preconditioner solves, gradients — stays in float32.

Two policies, named from the user-facing end down to the kernel:

  * ``precision="highest"`` → ``compute_dtype="float32"``: every stage f32.
    On the GPU this means true IEEE f32: importing :mod:`repro_torch` sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` (see
    :func:`disable_tf32`), so no plain matmul of the port rounds its
    operands to TF32's 10-bit mantissa behind the policy's back.
  * ``precision="mixed"``   → ``compute_dtype="bfloat16"``: kernel tiles
    and the tile × RHS product take bf16 operands with f32 accumulation
    (on the GPU the bf16 kernels, ``wgmma`` bf16 on the tensor cores).
    CG keeps its tolerance through a periodic f32 residual refresh inside
    mBCG (:mod:`repro_torch.core.mbcg`).

``compute_dtype`` is the low-level knob threaded through the kernels,
``prescale_inputs``, the ``KernelOperator`` family and
``LinearOperator.with_compute_dtype``; ``precision`` is the end-to-end knob
on ``BBMMSettings`` / ``ExactGP``.  Both accept either vocabulary —
:func:`normalize_compute_dtype` maps between them.
"""

from __future__ import annotations

import torch

PRECISIONS = ("highest", "mixed")

# precision alias → canonical compute_dtype name
_PRECISION_TO_COMPUTE = {"highest": "float32", "mixed": "bfloat16"}

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def disable_tf32() -> None:
    """Make every f32 matmul and convolution on the GPU a true f32 one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def normalize_compute_dtype(compute_dtype) -> str:
    """Canonical compute-dtype name ('float32' | 'bfloat16').

    Accepts either vocabulary ('highest'/'mixed' or 'float32'/'bfloat16')
    plus the torch dtypes themselves."""
    if compute_dtype in (torch.float32, torch.bfloat16):
        return str(compute_dtype).removeprefix("torch.")
    name = _PRECISION_TO_COMPUTE.get(compute_dtype, compute_dtype)
    if name not in _COMPUTE_DTYPES:
        raise ValueError(
            f"unknown compute_dtype {compute_dtype!r}; expected one of "
            f"{sorted(_COMPUTE_DTYPES)} or precision {PRECISIONS}"
        )
    return name


def as_torch_dtype(compute_dtype) -> torch.dtype:
    """The torch dtype for a compute_dtype / precision name."""
    return _COMPUTE_DTYPES[normalize_compute_dtype(compute_dtype)]


def validate_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision


def precision_compute_dtype(precision: str) -> str:
    """End-to-end precision knob → compute_dtype name."""
    return _PRECISION_TO_COMPUTE[validate_precision(precision)]


def is_reduced(compute_dtype) -> bool:
    """True when the policy selects bf16 operands.  Operators test their
    ``compute_dtype`` through this (never ``== "bfloat16"``), so the
    'mixed' alias means the same on every construction path."""
    return normalize_compute_dtype(compute_dtype) == "bfloat16"

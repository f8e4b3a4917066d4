"""The BBMM precision policy (counterpart of ``repro.core.precision``).

Two policies, named from the user-facing end down to the kernel:

  * ``precision="highest"`` → ``compute_dtype="float32"``: every stage f32.
    On the GPU this means true IEEE f32: importing :mod:`repro_torch` sets
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` (see
    :func:`disable_tf32`), so no plain matmul of the port rounds its
    operands to TF32's 10-bit mantissa behind the policy's back.
  * ``precision="mixed"``   → ``compute_dtype="bfloat16"``: bf16 kernel
    tiles with f32 accumulation.  Not ported yet — the bf16 kernel operands
    and the f32 residual refresh in mBCG come with ROADMAP Queue A step 10;
    until then every path that would run it raises ``NotImplementedError``
    (:func:`require_highest`).
"""

from __future__ import annotations

import torch

PRECISIONS = ("highest", "mixed")

# precision alias → canonical compute_dtype name
_PRECISION_TO_COMPUTE = {"highest": "float32", "mixed": "bfloat16"}

_COMPUTE_DTYPES = ("float32", "bfloat16")

MIXED_NOT_PORTED = (
    "precision='mixed' (bf16 kernel tiles + f32 residual refresh) is not "
    "ported yet: ROADMAP Queue A step 10"
)


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
            f"{_COMPUTE_DTYPES} or precision {PRECISIONS}"
        )
    return name


def validate_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return precision


def is_reduced(compute_dtype) -> bool:
    """True when the policy selects bf16 operands."""
    return normalize_compute_dtype(compute_dtype) == "bfloat16"


def require_highest(compute_dtype) -> str:
    """Validate a compute dtype and refuse the (not yet ported) bf16 one."""
    name = normalize_compute_dtype(compute_dtype)
    if is_reduced(name):
        raise NotImplementedError(MIXED_NOT_PORTED)
    return name

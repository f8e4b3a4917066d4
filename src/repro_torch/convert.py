"""Carry the reference's ExactGP parameters over to the port.

Both packages parameterize ``ExactGP`` by the same raw (softplus-inverse)
values — ``raw_lengthscale`` (scalar or ARD (d,)), ``raw_outputscale`` and
``raw_noise`` — so the conversion is a checked copy into f32 tensors on the
port's device, after which both packages compute the same kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

EXACT_GP_PARAMS = ("raw_lengthscale", "raw_outputscale", "raw_noise")


def params_from_jax(params: dict, device=None) -> dict[str, torch.Tensor]:
    """The port's ``ExactGP`` parameters from the reference's.

    ``params`` maps the reference's names to array-likes (numpy arrays, or
    anything ``np.asarray`` takes, jax arrays included).  ``device``
    defaults to CUDA, as every entry point of the port does."""
    device = resolve_device(device)
    if set(params) != set(EXACT_GP_PARAMS):
        raise ValueError(
            f"expected exactly the ExactGP parameters {EXACT_GP_PARAMS}, got "
            f"{sorted(params)}"
        )
    out = {}
    for name in EXACT_GP_PARAMS:
        value = np.array(params[name], dtype=np.float32)  # a copy: never alias the caller
        if name != "raw_lengthscale" and value.ndim != 0:
            raise ValueError(f"{name} must be a scalar, got shape {value.shape}")
        if value.ndim > 1:
            raise ValueError(f"raw_lengthscale must be scalar or (d,), got {value.shape}")
        out[name] = torch.as_tensor(value, device=device)
    return out

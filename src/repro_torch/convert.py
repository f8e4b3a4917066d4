"""Carry the reference's parameters over to the port.

* ``params_from_jax``: ExactGP.  Both packages parameterize ``ExactGP`` by
  the same raw (softplus-inverse) values — ``raw_lengthscale`` (scalar or
  ARD (d,)), ``raw_outputscale`` and ``raw_noise`` — so the conversion is a
  checked copy into f32 tensors on the port's device, after which both
  packages compute the same kernel.
* ``lm_params_from_jax``: an LM's parameter pytree (nested dicts), carried
  over leaf by leaf with its shapes and dtypes (bf16 stays bf16).
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


_LM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lm_leaf(path: str, value, device) -> torch.Tensor:
    arr = np.asarray(value)
    name = arr.dtype.name
    if name not in _LM_DTYPES:
        raise TypeError(f"{path}: parameters are float32 or bfloat16, got {name}")
    if name == "bfloat16":  # numpy has no bf16 of its own: move the bits
        t = torch.from_numpy(np.array(arr.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a copy: never alias the caller
    t = t.to(device)
    if tuple(t.shape) != arr.shape or t.dtype != _LM_DTYPES[name]:
        raise ValueError(f"{path}: converted to {t.dtype} {tuple(t.shape)}, "
                         f"expected {name} {arr.shape}")
    return t


def lm_params_from_jax(params: dict, device=None):
    """The port's LM parameters from the reference's pytree: the same nested
    dicts, each leaf (a numpy or jax array, float32 or bfloat16) a tensor of
    the same shape and dtype on ``device`` (CUDA by default, as every entry
    point of the port)."""
    device = resolve_device(device)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return _lm_leaf(path, node, device)

    if not isinstance(params, dict):
        raise TypeError(f"expected the reference's param dict, got {type(params).__name__}")
    return walk(params, "")

"""Carry the reference's parameters over to the port.

* ``params_from_jax``: the GP models.  Both packages parameterize each
  model by the same raw (softplus-inverse) values, so the conversion is a
  copy into f32 tensors on the port's device, names and shapes checked,
  after which both packages compute the same kernel.  ``model`` selects
  the layout: ``"exact"`` (``raw_lengthscale`` scalar or ARD (d,),
  ``raw_outputscale``, ``raw_noise``), ``"sgpr"`` (``inducing`` (m, d) and
  the exact GP's three), ``"blr"`` (``raw_prior_scale`` (d,),
  ``raw_noise``), ``"multitask"`` (``raw_lengthscale``,
  ``raw_outputscale``, ``raw_task_root`` (T, r), ``raw_task_diag`` (T,),
  ``raw_noise`` (T,), and a deep kernel's ``net`` where there is one),
  ``"dkl"`` (``net``, a list of ``{"w": (a, b), "b": (b,)}`` layers
  chaining a → b, and the exact GP's three) and ``"ski"`` (the exact GP's
  three, ``raw_lengthscale`` ARD (d,): one per grid axis).
* ``lm_params_from_jax``: an LM's parameter pytree (nested dicts), carried
  over leaf by leaf with its shapes and dtypes (bf16 stays bf16).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

EXACT_GP_PARAMS = ("raw_lengthscale", "raw_outputscale", "raw_noise")

_MODEL_NAMES = {"exact": "ExactGP", "sgpr": "SGPR", "blr": "BayesianLinearRegression",
                "multitask": "MultitaskGP", "dkl": "DKLExactGP", "ski": "SKI"}

#: model → (required names, optional names)
GP_PARAMS = {
    "exact": (EXACT_GP_PARAMS, ()),
    "sgpr": (("inducing",) + EXACT_GP_PARAMS, ()),
    "blr": (("raw_prior_scale", "raw_noise"), ()),
    "multitask": (("raw_lengthscale", "raw_outputscale", "raw_task_root", "raw_task_diag",
                   "raw_noise"), ("net",)),
    "dkl": (("net",) + EXACT_GP_PARAMS, ()),
    "ski": (EXACT_GP_PARAMS, ()),
}

#: name → allowed numbers of dimensions (``net`` is checked on its own)
_NDIMS = {
    "raw_lengthscale": (0, 1),  # scalar or ARD (d,)
    "raw_outputscale": (0,),
    "inducing": (2,),
    "raw_prior_scale": (1,),
    "raw_task_root": (2,),
    "raw_task_diag": (1,),
}

#: (model, name) → allowed numbers of dimensions where a model narrows _NDIMS
_MODEL_NDIMS = {
    ("multitask", "raw_noise"): (1,),  # per task
    ("ski", "raw_lengthscale"): (1,),  # per grid axis
}


def _gp_leaf(name: str, value, device, ndims) -> torch.Tensor:
    arr = np.array(value, dtype=np.float32)  # a copy: never alias the caller
    if arr.ndim not in ndims:
        kinds = {0: "a scalar", 1: "a vector", 2: "a matrix"}
        raise ValueError(f"{name} must be {' or '.join(kinds[k] for k in ndims)}, "
                         f"got shape {arr.shape}")
    return torch.as_tensor(arr, device=device)


def _net_from_jax(net, device) -> list[dict[str, torch.Tensor]]:
    """An MLP's layers, each ``{"w": (a, b), "b": (b,)}``, layer k's b the
    next layer's a."""
    if not isinstance(net, (list, tuple)):
        raise ValueError(f"net must be a list of {{'w', 'b'}} layers, got {type(net).__name__}")
    out = []
    for k, layer in enumerate(net):
        if set(layer) != {"w", "b"}:
            raise ValueError(f"net[{k}] must hold exactly 'w' and 'b', got {sorted(layer)}")
        w = _gp_leaf(f"net[{k}].w", layer["w"], device, (2,))
        b = _gp_leaf(f"net[{k}].b", layer["b"], device, (1,))
        if b.shape[0] != w.shape[1]:
            raise ValueError(f"net[{k}]: b {tuple(b.shape)} does not match w {tuple(w.shape)}")
        if out and out[-1]["w"].shape[1] != w.shape[0]:
            raise ValueError(f"net[{k}].w {tuple(w.shape)} does not follow "
                             f"net[{k - 1}].w {tuple(out[-1]['w'].shape)}")
        out.append({"w": w, "b": b})
    return out


def params_from_jax(params: dict, device=None, *, model: str = "exact") -> dict:
    """The port's parameters of a GP ``model`` (module docstring) from the
    reference's.

    ``params`` maps the reference's names to array-likes (numpy arrays, or
    anything ``np.asarray`` takes, jax arrays included; DKL's ``net`` a list
    of such dicts).  ``device`` defaults to CUDA, as every entry point of
    the port does."""
    if model not in GP_PARAMS:
        raise ValueError(f"model must be one of {sorted(GP_PARAMS)}, got {model!r}")
    device = resolve_device(device)
    required, optional = GP_PARAMS[model]
    if not set(required) <= set(params) <= set(required) | set(optional):
        raise ValueError(
            f"expected exactly the {_MODEL_NAMES[model]} parameters {required}"
            + (f" (optionally {optional})" if optional else "") + f", got {sorted(params)}"
        )
    out = {}
    for name in params:
        if name == "net":
            out[name] = _net_from_jax(params[name], device)
        else:
            ndims = _MODEL_NDIMS.get((model, name), _NDIMS.get(name, (0,)))
            out[name] = _gp_leaf(name, params[name], device, ndims)
    if model == "multitask":
        T = out["raw_task_root"].shape[0]
        for name in ("raw_task_diag", "raw_noise"):
            if out[name].shape != (T,):
                raise ValueError(f"{name} must be (T,) = ({T},), got {tuple(out[name].shape)}")
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

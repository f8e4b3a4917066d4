"""Device resolution for the port's entry points.

Every entry point (``ExactGP``, ``params_from_jax``, ``lm_params_from_jax``,
the LM serve driver's ``build_server``) runs on CUDA unless the caller asks
for the CPU.  A missing GPU is an error, never a quiet fall back
to the CPU: a serving process that silently ran its kernel matmuls on the
host would be orders of magnitude slower and still look healthy.
"""

from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """Raised when an entry point needs the GPU and none is visible."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU (``cuda``), and raises :class:`NoCudaDeviceError`
    when ``torch.cuda.is_available()`` is false.  An explicit ``"cpu"`` (or
    any ``torch.device``) is taken as given; an explicit CUDA device is
    checked the same way as the default.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev

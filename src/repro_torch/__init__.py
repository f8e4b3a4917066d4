"""repro_torch — the BBMM GP system in PyTorch, for NVIDIA Hopper (the
exact GP, SGPR, SKI / KISS-GP, Bayesian linear regression, deep kernel
learning, the multitask GP and the variational KL), and the LM
substrate's zamba2 serving path.

The port of the JAX/Pallas package ``repro`` (which stays the reference):
the same module layout and names, written in PyTorch's idiom, with every
Pallas kernel on its path replaced by a hand-written CUDA kernel.  This
package imports neither ``jax`` nor anything of ``repro``.

Multi-device: ``mode="cuda_sharded"`` (and ``cuda_partitioned`` under a
live mesh) shards the kernel's rows over a :class:`Mesh` of a
``torch.distributed`` world, installed with :func:`use_mesh`
(:mod:`repro_torch.distributed`).

Entry points (the GP models, ``params_from_jax``, ``lm_params_from_jax``,
``launch.serve.build_server``) run on CUDA unless the caller passes
``device="cpu"``, and raise :class:`repro_torch.device.NoCudaDeviceError`
when no GPU is present.

Importing the package sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False: the "highest" precision
policy is true f32 (see :mod:`repro_torch.core.precision`).
"""

from .core.precision import disable_tf32

disable_tf32()

from .convert import lm_params_from_jax, params_from_jax  # noqa: E402
from .device import NoCudaDeviceError, resolve_device  # noqa: E402
from .distributed import Mesh, make_mesh, use_mesh  # noqa: E402
from .core import gaussian_kl, root_logdet  # noqa: E402
from .gp import (  # noqa: E402
    SGPR,
    SKI,
    BayesianLinearRegression,
    DKLExactGP,
    ExactGP,
    Grid,
    MultitaskGP,
)

__all__ = [
    "SGPR",
    "SKI",
    "BayesianLinearRegression",
    "DKLExactGP",
    "ExactGP",
    "Grid",
    "Mesh",
    "MultitaskGP",
    "NoCudaDeviceError",
    "gaussian_kl",
    "lm_params_from_jax",
    "make_mesh",
    "params_from_jax",
    "resolve_device",
    "root_logdet",
    "use_mesh",
]

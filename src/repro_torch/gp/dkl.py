"""Deep kernel learning (Wilson et al. 2016; counterpart of
``repro.gp.dkl``).

``DKLExactGP`` puts an RBF / Matérn GP on a learned feature map, by
default a small tanh MLP.  The network's weights are kernel
hyperparameters held in a list of ``{"w", "b"}`` dicts, which the
differentiable MLL walks (:func:`repro_torch.core.tensor_leaves`), so its
backward reaches every weight.

The feature map lives inside the kernel, so DKL serves as the exact GP
does on featurized inputs (:class:`repro_torch.gp.model.KrylovCachePredictor`).
The deep kernel is not stationary in X: its operator runs in dense mode,
as the reference's does — no kernel launch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core import AddedDiagOperator, BBMMSettings, marginal_log_likelihood
from repro_torch.device import resolve_device

from .exact import KERNELS, _inv_softplus, _softplus
from .kernels import DeepKernel, KernelOperator
from .model import KrylovCachePredictor
from .training import fit_gp


def mlp_init(generator: torch.Generator, sizes, *, device=None):
    """He-initialized MLP weights: a list of ``{"w": (a, b), "b": (b,)}``,
    w drawn from ``generator`` (on ``device``, the generator's device by
    default)."""
    device = generator.device if device is None else device
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((a, b), generator=generator, device=generator.device) * math.sqrt(2.0 / a)
        params.append({"w": w.to(device), "b": torch.zeros((b,), device=device)})
    return params


def mlp_apply(params, X):
    """tanh MLP; the last layer is linear."""
    h = X
    for i, layer in enumerate(params):
        h = h @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            h = torch.tanh(h)
    return h


@dataclasses.dataclass
class DKLExactGP(KrylovCachePredictor):
    hidden: tuple = (32, 32, 2)  # the paper maps into a low-dimensional space
    kernel_type: str = "rbf"
    feature_fn: Callable | None = None  # override to plug another backbone
    settings: BBMMSettings = dataclasses.field(default_factory=BBMMSettings)
    # "highest" | "mixed" (the kernel contraction with bf16 operands; the
    # network stays f32); None follows settings.precision
    precision: str | None = None
    # the deep kernel has no fused step: True runs the unfused loop
    fuse_cg: bool | None = None
    # None → CUDA (raises without a GPU); "cpu" runs on the host
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.precision is not None:
            self.settings = dataclasses.replace(self.settings, precision=self.precision)
        if self.fuse_cg is not None:
            self.settings = dataclasses.replace(self.settings, fuse_cg=self.fuse_cg)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- GPModel protocol: inputs / parameterization --------------------------
    def prepare_inputs(self, X):
        return self._tensor(X)

    def init_params(self, X, generator: torch.Generator | None = None):
        """The network's weights from ``generator`` (default: a CPU generator
        seeded with 7)."""
        d = X if isinstance(X, int) else X.shape[-1]
        if generator is None:
            generator = torch.Generator().manual_seed(7)
        full = lambda v: torch.full((), _inv_softplus(v), dtype=torch.float32,  # noqa: E731
                                    device=self.device)
        net = [] if self.feature_fn is not None else mlp_init(
            generator, (d,) + tuple(self.hidden), device=self.device)
        return {
            "net": net,
            "raw_lengthscale": full(0.5),
            "raw_outputscale": full(1.0),
            "raw_noise": full(0.1),
        }

    def kernel(self, params):
        base = KERNELS[self.kernel_type](
            lengthscale=_softplus(params["raw_lengthscale"]),
            outputscale=_softplus(params["raw_outputscale"]),
        )
        feature_fn = self.feature_fn if self.feature_fn is not None else mlp_apply
        return DeepKernel(base=base, net_params=params["net"], feature_fn=feature_fn)

    def operator(self, params, data):
        return AddedDiagOperator(
            KernelOperator(kernel=self.kernel(params), X=self._tensor(data), mode="dense"),
            self.noise(params),
        )

    def noise(self, params):
        return _softplus(params["raw_noise"])

    def loss(self, params, data, y, generator):
        return -marginal_log_likelihood(
            self.operator(params, data), self._tensor(y), generator, self.settings
        )

    def fit(self, X, y, *, steps=150, lr=0.01, generator=None, callback=None):
        return fit_gp(self, X, y, steps=steps, lr=lr, generator=generator, callback=callback)

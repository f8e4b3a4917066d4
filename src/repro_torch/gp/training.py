"""The one fit driver behind every GP model (counterpart of
``repro.gp.training``).

:func:`fit_gp` drives any :class:`repro_torch.gp.model.GPModel` through the
shared path:

    data   = model.prepare_inputs(X)      # hyperparameter-free geometry, once
    params = model.init_params(X)         # leaves of torch.optim.Adam
    loop:    loss = model.loss(params, data, y, generator); loss.backward()

with ``torch.optim.Adam`` at the reference's β₁ = 0.9, β₂ = 0.999,
ε = 1e-8 (the same update, p −= lr·m̂/(√v̂ + ε), as ``repro.optim.adam``)
and every step's probes drawn from one seeded ``torch.Generator``.

Robustness, as in the reference:

  * non-finite ``X``/``y`` are rejected up front;
  * every step's loss is checked on the host under the model's
    ``settings.on_failure``: ``raise`` fails the fit, ``warn`` records the
    non-finite loss and skips the poisoned update; ``degrade`` would retry
    the step at ``precision="highest"`` after a mixed-precision failure,
    which needs mixed precision (ROADMAP Queue A step 10), so it raises
    ``NotImplementedError``.

The reference's fallback for a Pallas autodiff gap of its pinned jax has no
counterpart: the port's kernels carry their own backward.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable

import torch

from repro_torch.core.health import SolveFailure, SolveHealthWarning

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8

DEGRADE_NOT_PORTED = (
    "fit_gp: on_failure='degrade' retries a non-finite step at "
    "precision='highest' after a mixed-precision failure; mixed precision "
    "is not ported yet: ROADMAP Queue A step 10"
)


def _require_finite(name: str, x: torch.Tensor) -> None:
    bad = int((~torch.isfinite(x)).sum())
    if bad:
        raise ValueError(
            f"fit_gp: {name} contains {bad} non-finite value(s) (NaN/Inf) "
            f"out of {x.numel()}; drop or impute the offending rows before "
            "fitting — a single non-finite entry poisons every MLL solve "
            "and gradient"
        )


def fit_gp(
    model,
    X,
    y,
    *,
    steps: int = 100,
    lr: float = 0.1,
    generator: torch.Generator | None = None,
    callback: Callable[[int, float], None] | None = None,
):
    """Fit any GPModel with Adam on the mBCG marginal log likelihood.

    Args:
      model: anything with ``prepare_inputs`` / ``init_params`` / ``loss``
        and a ``device``.
      X, y: training inputs (n, d) and targets (n,).  Must be finite.
      steps, lr: Adam schedule.
      generator: draws every step's probes (default: seeded with 0, so the
        history is deterministic).
      callback: called after each step (taken or skipped) with its index
        and loss — per-step telemetry.

    Returns:
      (params, history) — the final parameters (detached tensors) and the
      per-step loss floats.
    """
    device = model.device
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    _require_finite("X", X)
    _require_finite("y", y)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    data = model.prepare_inputs(X)
    params = {k: v.detach().clone().requires_grad_() for k, v in model.init_params(X).items()}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
    policy = getattr(getattr(model, "settings", None), "on_failure", "warn")

    history = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, data, y, generator)
        loss_f = float(loss.detach())  # host sync: the forward is done here
        if not math.isfinite(loss_f):
            if policy == "raise":
                raise SolveFailure(
                    f"fit_gp: non-finite loss ({loss_f}) at step {i} with "
                    "on_failure='raise'"
                )
            if policy == "degrade":
                raise NotImplementedError(DEGRADE_NOT_PORTED)
            warnings.warn(
                f"fit_gp: non-finite loss at step {i}; skipping the poisoned "
                "update (parameters unchanged this step)",
                SolveHealthWarning,
                stacklevel=2,
            )
            history.append(loss_f)  # honest history: the step DID go bad
            if callback is not None:
                callback(i, loss_f)
            continue
        loss.backward()
        opt.step()
        history.append(loss_f)
        if callback is not None:
            callback(i, loss_f)
    return {k: v.detach() for k, v in params.items()}, history

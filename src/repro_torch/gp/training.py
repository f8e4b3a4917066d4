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
    non-finite loss and skips the poisoned update; ``degrade`` retries a
    non-finite step of a mixed-precision model once, from the pre-step
    parameters, at ``precision="highest"`` (with a
    :class:`~repro_torch.core.health.SolveHealthWarning`; the poisoned
    update is discarded and the fit goes on at "highest"), and later
    failures fall through to skip-and-warn.  The retry draws its probes
    anew from the generator, as the reference's splits a new key.

The reference's fallback for a Pallas autodiff gap of its pinned jax has no
counterpart: the port's kernels carry their own backward.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable

import torch

from repro_torch.core.health import SolveFailure, SolveHealthWarning

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


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
    precision_degraded = False
    i = 0
    while i < steps:
        opt.zero_grad(set_to_none=True)
        loss = model.loss(params, data, y, generator)
        loss_f = float(loss.detach())  # host sync: the forward is done here
        if not math.isfinite(loss_f):
            if policy == "raise":
                raise SolveFailure(
                    f"fit_gp: non-finite loss ({loss_f}) at step {i} with "
                    "on_failure='raise'"
                )
            if (
                policy == "degrade"
                and not precision_degraded
                and getattr(model, "settings", None) is not None
                and model.settings.precision != "highest"
            ):
                warnings.warn(
                    f"fit_gp: non-finite loss at step {i}; retrying from the "
                    "pre-step parameters at precision='highest' (the "
                    "poisoned update was discarded)",
                    SolveHealthWarning,
                    stacklevel=2,
                )
                precision_degraded = True
                model = _at_highest(model)
                continue  # retry the SAME step; params / Adam state not advanced
            warnings.warn(
                f"fit_gp: non-finite loss at step {i}; skipping the poisoned "
                "update (parameters unchanged this step)",
                SolveHealthWarning,
                stacklevel=2,
            )
            history.append(loss_f)  # honest history: the step DID go bad
            if callback is not None:
                callback(i, loss_f)
            i += 1
            continue
        loss.backward()
        opt.step()
        history.append(loss_f)
        if callback is not None:
            callback(i, loss_f)
        i += 1
    return {k: v.detach() for k, v in params.items()}, history


def _at_highest(model):
    """The model switched to precision="highest": through its own knob where
    it has one set (which wins over ``settings`` in ``__post_init__``), else
    through its settings."""
    if getattr(model, "precision", None) is not None:
        return dataclasses.replace(model, precision="highest")
    return dataclasses.replace(
        model, settings=dataclasses.replace(model.settings, precision="highest")
    )

"""Variational support (paper §7): the KL divergence through mBCG
(counterpart of ``repro.core.variational``).

    KL(N(μ₁, Σ₁) ‖ N(μ₂, Σ₂)) =
        ½ [ Tr(Σ₂⁻¹Σ₁) + (μ₂−μ₁)ᵀΣ₂⁻¹(μ₂−μ₁) − k + log|Σ₂| − log|Σ₁| ]

One engine call against Σ₂ gives the solve for the Mahalanobis term, the
probe solves whose pairing with Σ₁·zᵢ gives the stochastic trace
Tr(Σ₂⁻¹Σ₁), and the SLQ log|Σ₂|.  When Σ₁ is given by a root, log|Σ₁| is
exact through the matrix determinant lemma (:func:`root_logdet`).
"""

from __future__ import annotations

import torch

from .inference import BBMMSettings, engine_state
from .linear_operator import LinearOperator


def gaussian_kl(
    mu1: torch.Tensor,
    sigma1: LinearOperator,
    mu2: torch.Tensor,
    sigma2: LinearOperator,
    generator: torch.Generator,
    settings: BBMMSettings = BBMMSettings(),
    *,
    logdet_sigma1: torch.Tensor | None = None,
):
    """KL(N(μ₁,Σ₁) ‖ N(μ₂,Σ₂)) with all Σ₂ work in ONE mBCG call.

    ``generator`` draws the probes.  ``logdet_sigma1``: the exact log|Σ₁|
    where it is known (a root or Cholesky parameterization); otherwise a
    second engine call against Σ₁ estimates it, with the generator's next
    draws."""
    k = mu1.shape[0]
    diff = mu2 - mu1
    st = engine_state(sigma2, diff, generator, settings)
    # Tr(Σ₂⁻¹Σ₁) = E[(Σ₂⁻¹z)ᵀ Σ₁ (P̂⁻¹z)] with z ~ N(0, P̂)
    trace = torch.sum(st.probe_solves * sigma1.matmul(st.precond_probes)) / st.probes.shape[1]
    if logdet_sigma1 is None:
        logdet_sigma1 = engine_state(sigma1, diff, generator, settings).logdet
    return 0.5 * (trace + st.inv_quad - k + st.logdet - logdet_sigma1)


def root_logdet(root: torch.Tensor, sigma2) -> torch.Tensor:
    """Exact log|RRᵀ + σ²I| via the matrix determinant lemma (O(n·m²))."""
    n, m = root.shape
    sigma2 = torch.as_tensor(sigma2, dtype=root.dtype, device=root.device)
    inner = sigma2 * torch.eye(m, dtype=root.dtype, device=root.device) + root.T @ root
    chol = torch.linalg.cholesky(inner)
    return (n - m) * torch.log(sigma2) + 2.0 * torch.sum(torch.log(torch.diagonal(chol)))

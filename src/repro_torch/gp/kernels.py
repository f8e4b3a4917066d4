"""Stationary kernels (RBF, Matérn family) + the KernelOperator.

Counterpart of ``repro.gp.kernels``.  The KernelOperator is the exact-GP
blackbox matmul: it exposes ``K_XX @ M`` without committing to a
materialization strategy:

  * ``dense``   — materialize K for every matmul (small n; the plain path)
  * ``blocked`` — row-block streaming: each block of K is formed, used and
                  discarded (O(b·n) live memory)
  * ``cuda``    — the hand-written fused CUDA kernel
                  (``repro_torch/kernels/kernel_matmul``), K never formed;
                  the counterpart of the reference's ``pallas`` mode.  On
                  CPU tensors the kernel's wrapper runs its plain version.
  * ``cuda_partitioned`` — K streamed one (panel_rows × n) row-panel at a
                  time (:class:`repro_torch.core.PartitionedKernelOperator`),
                  the million-row path; the reference's
                  ``pallas_partitioned``.  ``panel_backend`` picks the
                  kernels ("cuda") or plain torch panels ("torch"; the
                  reference's "xla"); "auto" follows X's device.

All four are numerically interchangeable; the tests assert it.

``compute_dtype`` ('float32' | 'bfloat16', or the 'highest' / 'mixed'
aliases; :mod:`repro_torch.core.precision`) selects the operands of the
heavy contraction: under bf16, ``dense`` and ``blocked`` multiply the f32
kernel block and M as bf16 operands with f32 accumulation (X itself is not
rounded), and ``cuda`` prepares with X/ℓ rounded to bf16 and launches the
bf16 kernels — as the reference's ``dense``, ``blocked`` and ``pallas``
modes do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core.linear_operator import LinearOperator, _mixed_matmul
from repro_torch.core.precision import is_reduced, normalize_compute_dtype

MODES = ("dense", "blocked", "cuda", "cuda_partitioned")

# reference modes that have no counterpart yet, and the ROADMAP step that
# brings each
_UNPORTED_MODES = {
    "pallas_sharded": "ROADMAP Queue A step 16 (multi-device)",
}


def sq_dist(X1: torch.Tensor, X2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances, numerically clipped at 0."""
    n1 = torch.sum(X1 * X1, dim=-1)
    n2 = torch.sum(X2 * X2, dim=-1)
    d2 = n1[:, None] + n2[None, :] - 2.0 * (X1 @ X2.T)
    return torch.clamp(d2, min=0.0)


@dataclasses.dataclass(frozen=True)
class RBFKernel:
    """k(x, x') = s · exp(−‖x−x'‖² / 2ℓ²)  (ARD when ℓ is a vector)."""

    lengthscale: torch.Tensor
    outputscale: torch.Tensor

    def __call__(self, X1, X2):
        d2 = sq_dist(X1 / self.lengthscale, X2 / self.lengthscale)
        return self.outputscale * torch.exp(-0.5 * d2)

    def diag(self, X):
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) * self.outputscale


@dataclasses.dataclass(frozen=True)
class MaternKernel:
    """Matérn-ν for ν ∈ {0.5, 1.5, 2.5}."""

    lengthscale: torch.Tensor
    outputscale: torch.Tensor
    nu: float = 2.5

    def __call__(self, X1, X2):
        d = torch.sqrt(sq_dist(X1 / self.lengthscale, X2 / self.lengthscale) + 1e-20)
        if self.nu == 0.5:
            k = torch.exp(-d)
        elif self.nu == 1.5:
            a = math.sqrt(3.0) * d
            k = (1.0 + a) * torch.exp(-a)
        elif self.nu == 2.5:
            a = math.sqrt(5.0) * d
            k = (1.0 + a + a * a / 3.0) * torch.exp(-a)
        else:
            raise ValueError(f"unsupported nu={self.nu}")
        return self.outputscale * k

    def diag(self, X):
        return torch.ones(X.shape[0], dtype=X.dtype, device=X.device) * self.outputscale


@dataclasses.dataclass(frozen=True)
class DeepKernel:
    """k(g(x), g(x')) — deep kernel learning (paper §6 SKI+DKL experiments).

    ``feature_fn(net_params, X)`` is any torch feature extractor (an MLP,
    :func:`repro_torch.gp.dkl.mlp_apply`); ``net_params`` is its weights in
    lists / dicts of tensors, which :func:`repro_torch.core.tensor_leaves`
    walks, so the MLL's gradient reaches them as it reaches any other
    hyperparameter.  Not stationary in X: a :class:`KernelOperator` over it
    runs in dense or blocked mode (``mode="cuda"`` raises TypeError)."""

    base: object  # RBFKernel | MaternKernel on the features
    net_params: object
    feature_fn: Callable | None = None

    def __call__(self, X1, X2):
        Z1 = self.feature_fn(self.net_params, X1)
        Z2 = self.feature_fn(self.net_params, X2)
        return self.base(Z1, Z2)

    def diag(self, X):
        return self.base.diag(X)


@dataclasses.dataclass(frozen=True)
class KernelOperator(LinearOperator):
    """Exact-GP kernel matrix K(X, X) as a lazy blackbox matmul."""

    kernel: object
    X: torch.Tensor  # (n, d)
    mode: str = "dense"  # dense | blocked | cuda | cuda_partitioned
    block_size: int = 512
    compute_dtype: str = "float32"  # the product's operands (module docstring)
    # cuda_partitioned knobs (see core.PartitionedKernelOperator):
    panel_rows: int = 0  # 0 → the backend's default height
    panel_budget_bytes: int = 0  # 0 → the chooser's default budget
    panel_backend: str = "auto"  # auto | cuda | torch

    def __post_init__(self):
        if self.mode in _UNPORTED_MODES:
            raise NotImplementedError(
                f"KernelOperator mode {self.mode!r} is not ported yet: "
                f"{_UNPORTED_MODES[self.mode]}"
            )
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")

    @property
    def shape(self):
        n = self.X.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def device(self):
        return self.X.device

    def matmul(self, M):
        squeeze = M.dim() == 1
        if squeeze:
            M = M[:, None]
        if self.mode == "dense":
            out = self._contract(self.kernel(self.X, self.X), M)
        elif self.mode == "blocked":
            out = self._blocked_matmul(M)
        else:
            out = self.prepare().matmul(M)
        return out[:, 0] if squeeze else out

    def prepare(self):
        """Hoist the lengthscale pre-scaling out of the CG loop (cuda mode):
        returns an operator whose per-iteration matmul consumes the already
        scaled X.  ``cuda_partitioned`` prepares into the streaming
        :class:`repro_torch.core.PartitionedKernelOperator`.  Other modes
        are returned as they are.  Under grad mode the scaled X keeps its
        graph, so the matmul's gradient reaches the lengthscale."""
        if self.mode == "cuda_partitioned":
            return self._partitioned().prepare()
        if self.mode != "cuda":
            return self
        from repro_torch.kernels.kernel_matmul.ops import (
            prescale_inputs,
            stationary_kernel_type,
        )

        kernel_type = stationary_kernel_type(self.kernel)  # a deep kernel raises here
        return PreparedKernelOperator(
            kernel=self.kernel,
            X=self.X,
            Xs=prescale_inputs(self.X, self.kernel.lengthscale, self.compute_dtype),
            kernel_type=kernel_type,
            compute_dtype=self.compute_dtype,
        )

    def with_compute_dtype(self, compute_dtype):
        return dataclasses.replace(self, compute_dtype=normalize_compute_dtype(compute_dtype))

    def _contract(self, K, M):
        """A kernel block times M under this operator's policy."""
        return _mixed_matmul(K, M) if is_reduced(self.compute_dtype) else K @ M

    def _partitioned(self):
        """The streaming operator behind ``mode="cuda_partitioned"``."""
        from repro_torch.core.linear_operator import PartitionedKernelOperator

        return PartitionedKernelOperator(
            kernel=self.kernel,
            X=self.X,
            panel_rows=self.panel_rows,
            panel_budget_bytes=self.panel_budget_bytes,
            backend=self.panel_backend,
            compute_dtype=self.compute_dtype,
        )

    def fused_cg_step_fn(self, sigma2=None):
        """Fused CG capability: cuda mode delegates to its prepared form (the
        engine prepares before the loop anyway), ``cuda_partitioned`` to
        the panel-fused step (one fused launch per row-panel per
        iteration); dense and blocked have none and keep the unfused
        loop."""
        if self.mode == "cuda_partitioned":
            return self._partitioned().fused_cg_step_fn(sigma2=sigma2)
        if self.mode != "cuda":
            return None
        return self.prepare().fused_cg_step_fn(sigma2=sigma2)

    def _blocked_matmul(self, M):
        n = self.X.shape[0]
        b = min(self.block_size, n)
        return torch.cat(
            [self._contract(self.kernel(self.X[i : i + b], self.X), M) for i in range(0, n, b)],
            dim=-2,
        )

    def row(self, i):
        return self.kernel(self.X[i][None, :], self.X)[0]

    def diagonal(self):
        return self.kernel.diag(self.X)


@dataclasses.dataclass(frozen=True)
class PreparedKernelOperator(LinearOperator):
    """KernelOperator(mode='cuda') after ``prepare()``: X is already divided
    by the (possibly ARD) lengthscale, so the CG loop's per-iteration matmul
    is one kernel launch and nothing else.  The f32 matmul is differentiable
    in Xs and the outputscale (the gradient kernel is its backward); under
    a bf16 ``compute_dtype`` it launches the bf16 kernel and carries no
    gradient."""

    kernel: object  # original kernel (row/diagonal accessors, outputscale)
    X: torch.Tensor  # (n, d) original inputs (row/diagonal accessors)
    Xs: torch.Tensor  # (n, d) pre-scaled, f32 values (bf16-rounded under bf16), contiguous
    kernel_type: str = "rbf"
    compute_dtype: str = "float32"

    @property
    def shape(self):
        n = self.X.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.X.dtype

    @property
    def device(self):
        return self.X.device

    def matmul(self, M):
        from repro_torch.kernels.kernel_matmul.ops import fused_kernel_matmul_prescaled

        return fused_kernel_matmul_prescaled(
            self.Xs,
            self.Xs,
            M,
            self.kernel.outputscale,
            0.0,
            kernel_type=self.kernel_type,
            compute_dtype=self.compute_dtype,
        )

    def with_compute_dtype(self, compute_dtype):
        # Xs keeps its stored values (bf16-rounded values cannot regain f32
        # bits); the kernel takes operands at the requested compute_dtype
        return dataclasses.replace(self, compute_dtype=normalize_compute_dtype(compute_dtype))

    def fused_cg_step_fn(self, sigma2=None):
        """One-launch CG iteration (B3): the state update, V = (K + σ²I)·D and
        the dᵀV / rᵀr / rᵀV / vᵀV reductions (see
        :func:`repro_torch.kernels.kernel_matmul.ops.fused_cg_step_prescaled`).
        A batched σ² has no scalar tile term: None."""
        from repro_torch.kernels.kernel_matmul.ops import fused_cg_step_prescaled

        s2 = torch.zeros((), device=self.Xs.device) if sigma2 is None else torch.as_tensor(sigma2)
        if s2.dim():
            return None
        Xs, outputscale, kernel_type = self.Xs, self.kernel.outputscale, self.kernel_type
        compute_dtype = self.compute_dtype

        def step(U, R, D, V, alpha, beta, gamma):
            return fused_cg_step_prescaled(
                Xs, U, R, D, V, alpha, beta, gamma, outputscale, s2, kernel_type=kernel_type,
                compute_dtype=compute_dtype,
            )

        return step

    def row(self, i):
        return self.kernel(self.X[i][None, :], self.X)[0]

    def diagonal(self):
        return self.kernel.diag(self.X)


@dataclasses.dataclass(frozen=True)
class CrossKernelOperator:
    """k(X1, X2) rectangular block for predictions (not square — helper).

    ``compute_dtype`` routes the test-vs-train contraction through the same
    precision policy as the training operators (bf16 operands, f32
    accumulation under "bfloat16" / "mixed"), so a model run at
    ``precision="mixed"`` serves its means through the same reduced-precision
    contraction."""

    kernel: object
    X1: torch.Tensor
    X2: torch.Tensor
    compute_dtype: str = "float32"

    @property
    def shape(self):
        return (self.X1.shape[0], self.X2.shape[0])

    def to_dense(self):
        return self.kernel(self.X1, self.X2)

    def contract(self, K, M):
        """K @ M under this operator's precision policy, for a precomputed
        cross block K (``to_dense()`` or its transpose), so serving
        evaluates the kernel block once."""
        return _mixed_matmul(K, M) if is_reduced(self.compute_dtype) else K @ M

    def matmul(self, M):
        return self.contract(self.kernel(self.X1, self.X2), M)

    def rmatmul(self, M):
        return self.contract(self.kernel(self.X2, self.X1), M)

    def with_compute_dtype(self, compute_dtype):
        return dataclasses.replace(self, compute_dtype=normalize_compute_dtype(compute_dtype))

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

All three are numerically interchangeable; the tests assert it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.linear_operator import LinearOperator

MODES = ("dense", "blocked", "cuda")

# reference modes that have no counterpart yet, and the ROADMAP step that
# brings each
_UNPORTED_MODES = {
    "pallas_sharded": "ROADMAP Queue A step 16 (multi-device)",
    "pallas_partitioned": "ROADMAP Queue A step 12 (partitioned million-row path)",
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
class KernelOperator(LinearOperator):
    """Exact-GP kernel matrix K(X, X) as a lazy blackbox matmul."""

    kernel: object
    X: torch.Tensor  # (n, d)
    mode: str = "dense"  # dense | blocked | cuda
    block_size: int = 512

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
            out = self.kernel(self.X, self.X) @ M
        elif self.mode == "blocked":
            out = self._blocked_matmul(M)
        else:
            out = self.prepare().matmul(M)
        return out[:, 0] if squeeze else out

    def prepare(self):
        """Hoist the lengthscale pre-scaling out of the CG loop (cuda mode):
        returns an operator whose per-iteration matmul consumes the already
        scaled X.  Other modes are returned as they are.  Under grad mode
        the scaled X keeps its graph, so the matmul's gradient reaches the
        lengthscale."""
        if self.mode != "cuda":
            return self
        from repro_torch.kernels.kernel_matmul.ops import (
            prescale_inputs,
            stationary_kernel_type,
        )

        return PreparedKernelOperator(
            kernel=self.kernel,
            X=self.X,
            Xs=prescale_inputs(self.X, self.kernel.lengthscale),
            kernel_type=stationary_kernel_type(self.kernel),
        )

    def fused_cg_step_fn(self, sigma2=None):
        """Fused CG capability: cuda mode delegates to its prepared form (the
        engine prepares before the loop anyway); dense and blocked have none
        and keep the unfused loop."""
        if self.mode != "cuda":
            return None
        return self.prepare().fused_cg_step_fn(sigma2=sigma2)

    def _blocked_matmul(self, M):
        n = self.X.shape[0]
        b = min(self.block_size, n)
        return torch.cat(
            [self.kernel(self.X[i : i + b], self.X) @ M for i in range(0, n, b)]
        )

    def row(self, i):
        return self.kernel(self.X[i][None, :], self.X)[0]

    def diagonal(self):
        return self.kernel.diag(self.X)


@dataclasses.dataclass(frozen=True)
class PreparedKernelOperator(LinearOperator):
    """KernelOperator(mode='cuda') after ``prepare()``: X is already divided
    by the (possibly ARD) lengthscale, so the CG loop's per-iteration matmul
    is one kernel launch and nothing else.  The matmul is differentiable in
    Xs and the outputscale (the gradient kernel is its backward)."""

    kernel: object  # original kernel (row/diagonal accessors, outputscale)
    X: torch.Tensor  # (n, d) original inputs (row/diagonal accessors)
    Xs: torch.Tensor  # (n, d) pre-scaled, f32, contiguous
    kernel_type: str = "rbf"

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
        )

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

        def step(U, R, D, V, alpha, beta, gamma):
            return fused_cg_step_prescaled(
                Xs, U, R, D, V, alpha, beta, gamma, outputscale, s2, kernel_type=kernel_type
            )

        return step

    def row(self, i):
        return self.kernel(self.X[i][None, :], self.X)[0]

    def diagonal(self):
        return self.kernel.diag(self.X)


@dataclasses.dataclass(frozen=True)
class CrossKernelOperator:
    """k(X1, X2) rectangular block for predictions (not square — helper)."""

    kernel: object
    X1: torch.Tensor
    X2: torch.Tensor

    @property
    def shape(self):
        return (self.X1.shape[0], self.X2.shape[0])

    def to_dense(self):
        return self.kernel(self.X1, self.X2)

    def contract(self, K, M):
        """K @ M for a precomputed cross block K (``to_dense()`` or its
        transpose), so serving evaluates the kernel block once."""
        return K @ M

    def matmul(self, M):
        return self.contract(self.kernel(self.X1, self.X2), M)

    def rmatmul(self, M):
        return self.contract(self.kernel(self.X2, self.X1), M)

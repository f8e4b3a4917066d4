"""LinearOperator: the blackbox matrix abstraction at the heart of BBMM.

Counterpart of ``repro.core.linear_operator``, main-path subset:
:class:`LinearOperator`, :class:`DenseOperator`, :class:`DiagOperator` and
:class:`AddedDiagOperator`.  An operator packages the blackbox routine
``matmul(M) = K @ M`` with the cheap accessors the engine needs —
``diagonal()`` and ``row(i)`` drive the pivoted-Cholesky preconditioner.

Operators are frozen dataclasses holding tensors; there are no pytrees and
no jit.  The device is the device of the tensors they hold.
:func:`tensor_leaves` / :func:`replace_tensor_leaves` list and swap the
tensors an operator holds (its kernel's hyperparameters included) — the
counterpart of the reference's pytree leaves, through which the
differentiable MLL takes its gradients.
"""

from __future__ import annotations

import dataclasses

import torch

from .precision import require_highest


def tensor_leaves(obj) -> list[torch.Tensor]:
    """Every tensor a (nested) dataclass holds, depth first in field order:
    for an operator, its data, its kernel's hyperparameters and its noise."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [
            leaf
            for f in dataclasses.fields(obj)
            if f.init
            for leaf in tensor_leaves(getattr(obj, f.name))
        ]
    return []


def replace_tensor_leaves(obj, leaves):
    """``obj`` with its :func:`tensor_leaves` replaced, in order, by
    ``leaves`` (an iterable of as many tensors)."""
    it = iter(leaves)

    def rebuild(o):
        if isinstance(o, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            changes = {f.name: rebuild(getattr(o, f.name)) for f in dataclasses.fields(o) if f.init}
            return dataclasses.replace(o, **changes)
        return o

    out = rebuild(obj)
    if next(it, None) is not None:
        raise ValueError("replace_tensor_leaves: more leaves than the object holds")
    return out


class LinearOperator:
    """Abstract symmetric (PSD in GP usage) linear operator of shape (n, n)."""

    # -- required ---------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        raise NotImplementedError

    def matmul(self, M: torch.Tensor) -> torch.Tensor:
        """K @ M for M of shape (n, t) (or (n,) vector)."""
        raise NotImplementedError

    # -- optional (defaults via matmul; O(n) columns = slow, override) ----
    def diagonal(self) -> torch.Tensor:
        n = self.shape[0]
        return torch.stack([self.row(i)[i] for i in range(n)])

    def row(self, i) -> torch.Tensor:
        n = self.shape[0]
        e = torch.zeros((n, 1), dtype=self.dtype, device=self.device)
        e[i] = 1.0
        return self.matmul(e)[:, 0]

    def to_dense(self) -> torch.Tensor:
        n = self.shape[0]
        return self.matmul(torch.eye(n, dtype=self.dtype, device=self.device))

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    # -- solver preparation ------------------------------------------------
    def prepare(self) -> "LinearOperator":
        """Return an equivalent operator with per-solve work hoisted (the
        engine calls this ONCE before the CG loop).  Default: no-op."""
        return self

    # -- fused CG capability ----------------------------------------------
    def fused_cg_step_fn(self, sigma2=None):
        """The operator's fused CG iteration (a ``CGStepFn`` of K + σ²I, see
        :mod:`repro_torch.core.mbcg`), or None when it has none — the
        engine then runs the unfused loop.  Default: None."""
        return None

    # -- precision policy --------------------------------------------------
    def with_compute_dtype(self, compute_dtype) -> "LinearOperator":
        """Only "highest" (f32) is ported: validates, and refuses bf16."""
        require_highest(compute_dtype)
        return self

    def add_diagonal(self, sigma2) -> "AddedDiagOperator":
        return AddedDiagOperator(self, sigma2)

    def __call__(self, M):
        return self.matmul(M)


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Explicit symmetric matrix."""

    matrix: torch.Tensor

    @property
    def shape(self):
        return tuple(self.matrix.shape)

    @property
    def dtype(self):
        return self.matrix.dtype

    @property
    def device(self):
        return self.matrix.device

    def matmul(self, M):
        return self.matrix @ M

    def diagonal(self):
        return torch.diagonal(self.matrix)

    def row(self, i):
        return self.matrix[i]

    def to_dense(self):
        return self.matrix


@dataclasses.dataclass(frozen=True)
class DiagOperator(LinearOperator):
    diag: torch.Tensor

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    @property
    def device(self):
        return self.diag.device

    def matmul(self, M):
        if M.dim() == 1:
            return self.diag * M
        return self.diag[:, None] * M

    def diagonal(self):
        return self.diag

    def row(self, i):
        r = torch.zeros_like(self.diag)
        r[i] = self.diag[i]
        return r

    def to_dense(self):
        return torch.diag(self.diag)


@dataclasses.dataclass(frozen=True)
class AddedDiagOperator(LinearOperator):
    """K̂ = K + σ²·I — the paper's hatted matrix.

    Kept as its own node because the engine builds the pivoted-Cholesky
    preconditioner from ``base`` and the noise separately
    (P̂ = L_k L_kᵀ + σ²I)."""

    base: LinearOperator
    sigma2: torch.Tensor  # scalar

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def matmul(self, M):
        return self.base.matmul(M) + self.sigma2 * M

    def diagonal(self):
        return self.base.diagonal() + self.sigma2

    def row(self, i):
        r = self.base.row(i).clone()
        r[i] += self.sigma2
        return r

    def to_dense(self):
        # structural materialization (base dense + σ²I), independent of the
        # blackbox matmul
        dense = self.base.to_dense()
        eye = torch.eye(dense.shape[-1], dtype=dense.dtype, device=dense.device)
        return dense + self.sigma2 * eye

    def prepare(self):
        return AddedDiagOperator(self.base.prepare(), self.sigma2)

    def with_compute_dtype(self, compute_dtype):
        return AddedDiagOperator(self.base.with_compute_dtype(compute_dtype), self.sigma2)

    def fused_cg_step_fn(self, sigma2=None):
        """Fold this diagonal into the base kernel's σ² tile term (the fused
        kernel adds it at global row == column, so the fused step IS K̂·D).
        A batched σ² has no scalar tile term: None, the unfused loop."""
        s2 = torch.as_tensor(self.sigma2)
        if s2.dim():
            return None
        if sigma2 is not None:
            s2 = s2 + sigma2
        return self.base.fused_cg_step_fn(sigma2=s2)

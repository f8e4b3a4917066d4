"""LinearOperator: the blackbox matrix abstraction at the heart of BBMM.

Counterpart of ``repro.core.linear_operator``, single-device subset:
:class:`LinearOperator` (with its algebra: ``+`` → :class:`SumOperator`,
a scalar ``*`` → :class:`ScaledOperator`), :class:`DenseOperator`,
:class:`DiagOperator`, :class:`AddedDiagOperator`,
:class:`LowRankRootOperator` (R·Rᵀ, the SGPR / BLR kernel), SKI's
structured operators (:class:`ToeplitzOperator`, an FFT product;
:class:`KroneckerOperator` over grid axes; :class:`InterpolatedOperator`,
W·K·Wᵀ for a sparse W), the fully blackbox :class:`CallableOperator`, the
multitask operators (:class:`KroneckerKernelOperator`,
:class:`HadamardKroneckerOperator`, :class:`KroneckerAddedDiagOperator`),
:class:`BatchDenseOperator` (b independent
dense blocks, the multi-restart path) and :class:`PartitionedKernelOperator`
(K streamed one row-panel at a time, the million-row path) with its
accounting surface (:class:`PanelLaunch`, :func:`panel_accounting`), and
the robustness harness (:class:`FaultSchedule`,
:class:`FaultInjectingOperator`).  An
operator packages the blackbox routine ``matmul(M) = K @ M`` with the cheap
accessors the engine needs — ``diagonal()`` and ``row(i)`` drive the
pivoted-Cholesky preconditioner.

Operators are frozen dataclasses holding tensors; there are no pytrees and
no jit.  The device is the device of the tensors they hold.
:func:`tensor_leaves` / :func:`replace_tensor_leaves` list and swap the
tensors an operator holds (its kernel's hyperparameters included, and the
weights of a deep kernel's network, held as lists and dicts) — the
counterpart of the reference's pytree leaves, through which the
differentiable MLL takes its gradients.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Any, Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.distributed.sharding import all_gather_rows, current_mesh, ordered_psum, row_band

from .precision import is_reduced, normalize_compute_dtype


def _mixed_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B with bf16 operands and f32 accumulation — the reduced-precision
    contraction every mixed-policy operator shares: both operands rounded to
    bf16, their widened values multiplied in f32 (TF32 is off, so the
    products are exact and the sum is f32).  A matmul of the bf16 tensors
    themselves would return bf16."""
    return A.to(torch.bfloat16).float() @ B.to(torch.bfloat16).float()


def tensor_leaves(obj) -> list[torch.Tensor]:
    """Every tensor a (nested) dataclass holds, depth first in field order,
    through lists, tuples and dict values (in insertion order) too: for an
    operator, its data, its kernel's hyperparameters (a deep kernel's
    network weights included) and its noise.  Callables hold no leaf."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [
            leaf
            for f in dataclasses.fields(obj)
            if f.init
            for leaf in tensor_leaves(getattr(obj, f.name))
        ]
    if isinstance(obj, (list, tuple)):
        return [leaf for item in obj for leaf in tensor_leaves(item)]
    if isinstance(obj, dict):
        return [leaf for item in obj.values() for leaf in tensor_leaves(item)]
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
        if isinstance(o, (list, tuple)):
            items = [rebuild(item) for item in o]
            return type(o)(*items) if hasattr(o, "_fields") else type(o)(items)
        if isinstance(o, dict):
            return {k: rebuild(v) for k, v in o.items()}
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
        """An equivalent operator whose matmul runs its heavy contractions
        at ``compute_dtype`` ('float32' | 'bfloat16', or the 'highest' /
        'mixed' aliases), always accumulating in f32.

        Default: no-op (validated) — operators with no reduced-precision
        formulation (a diagonal, say) stay f32 under the mixed policy, which
        is correct, just not faster.  Wrappers recurse into their children;
        σ² diagonals stay f32."""
        normalize_compute_dtype(compute_dtype)
        return self

    def entries(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """K[a, b] elementwise for integer tensors a, b of one shape.
        Default: one ``row`` per distinct a; structured operators compute
        the entries directly."""
        rows, inverse = torch.unique(a, return_inverse=True)
        return torch.stack([self.row(i) for i in rows])[inverse, b]

    # -- algebra ------------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, LinearOperator):
            return SumOperator((self, other))
        raise TypeError(other)

    def __mul__(self, scalar):
        return ScaledOperator(self, torch.as_tensor(scalar, dtype=self.dtype, device=self.device))

    __rmul__ = __mul__

    def add_diagonal(self, sigma2) -> "AddedDiagOperator":
        return AddedDiagOperator(self, sigma2)

    def __call__(self, M):
        return self.matmul(M)


@dataclasses.dataclass(frozen=True)
class DenseOperator(LinearOperator):
    """Explicit symmetric matrix.

    ``compute_dtype="bfloat16"`` rounds both matmul operands to bf16 and
    accumulates in f32 (:func:`_mixed_matmul`)."""

    matrix: torch.Tensor
    compute_dtype: str = "float32"

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
        if is_reduced(self.compute_dtype):
            return _mixed_matmul(self.matrix, M)
        return self.matrix @ M

    def with_compute_dtype(self, compute_dtype):
        return dataclasses.replace(self, compute_dtype=normalize_compute_dtype(compute_dtype))

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
class LowRankRootOperator(LinearOperator):
    """R·Rᵀ for a tall-skinny root R (n, m) — the SoR / SGPR kernel
    K_XU·K_UU⁻¹·K_UX with R = K_XU·L⁻ᵀ, L = chol(K_UU), and BLR's scaled
    features: an O(t·n·m) matmul of two plain contractions, no kernel.

    ``compute_dtype="bfloat16"`` runs both contractions with bf16 operands
    and f32 accumulation (:func:`_mixed_matmul`)."""

    root: torch.Tensor  # (n, m)
    compute_dtype: str = "float32"

    @property
    def shape(self):
        n = self.root.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.root.dtype

    @property
    def device(self):
        return self.root.device

    def matmul(self, M):
        R = self.root
        if is_reduced(self.compute_dtype):
            return _mixed_matmul(R, _mixed_matmul(R.T, M))
        return R @ (R.T @ M)

    def with_compute_dtype(self, compute_dtype):
        return dataclasses.replace(self, compute_dtype=normalize_compute_dtype(compute_dtype))

    def diagonal(self):
        return torch.sum(self.root * self.root, dim=-1)

    def row(self, i):
        return self.root @ self.root[i]


@dataclasses.dataclass(frozen=True)
class ScaledOperator(LinearOperator):
    """s·K for a scalar s (kept f32 under every precision policy)."""

    base: LinearOperator
    scale: torch.Tensor

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
        return self.scale * self.base.matmul(M)

    def diagonal(self):
        return self.scale * self.base.diagonal()

    def row(self, i):
        return self.scale * self.base.row(i)

    def prepare(self):
        return ScaledOperator(self.base.prepare(), self.scale)

    def with_compute_dtype(self, compute_dtype):
        return ScaledOperator(self.base.with_compute_dtype(compute_dtype), self.scale)


@dataclasses.dataclass(frozen=True)
class SumOperator(LinearOperator):
    """K₁ + K₂ + … — compositional kernels (paper §5 "Compositions")."""

    ops: tuple

    @property
    def shape(self):
        return self.ops[0].shape

    @property
    def dtype(self):
        return self.ops[0].dtype

    @property
    def device(self):
        return self.ops[0].device

    def _sum(self, parts):
        out = next(parts)
        for part in parts:
            out = out + part
        return out

    def matmul(self, M):
        return self._sum(op.matmul(M) for op in self.ops)

    def diagonal(self):
        return self._sum(op.diagonal() for op in self.ops)

    def row(self, i):
        return self._sum(op.row(i) for op in self.ops)

    def prepare(self):
        return SumOperator(tuple(op.prepare() for op in self.ops))

    def with_compute_dtype(self, compute_dtype):
        return SumOperator(tuple(op.with_compute_dtype(compute_dtype) for op in self.ops))


@dataclasses.dataclass(frozen=True)
class AddedDiagOperator(LinearOperator):
    """K̂ = K + σ²·I — the paper's hatted matrix.

    Kept as its own node because the engine builds the pivoted-Cholesky
    preconditioner from ``base`` and the noise separately
    (P̂ = L_k L_kᵀ + σ²I).  σ² is a scalar, or (b,) — one noise level per
    block of a batched base (:class:`BatchDenseOperator`)."""

    base: LinearOperator
    sigma2: torch.Tensor  # scalar, or (b,) for a batch of noise levels

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _s2(self, extra_dims: int):
        """σ² shaped to broadcast against ``extra_dims`` trailing dims."""
        s2 = torch.as_tensor(self.sigma2)
        return s2.reshape(s2.shape + (1,) * extra_dims) if s2.dim() else s2

    def matmul(self, M):
        return self.base.matmul(M) + self._s2(2 if M.dim() > 1 else 1) * M

    def diagonal(self):
        return self.base.diagonal() + self._s2(1)

    def row(self, i):
        r = self.base.row(i).clone()
        r[i] += self.sigma2
        return r

    def to_dense(self):
        # structural materialization (base dense + σ²I), independent of the
        # blackbox matmul
        dense = self.base.to_dense()
        eye = torch.eye(dense.shape[-1], dtype=dense.dtype, device=dense.device)
        return dense + self._s2(2) * eye

    def prepare(self):
        return AddedDiagOperator(self.base.prepare(), self.sigma2)

    def with_compute_dtype(self, compute_dtype):
        return AddedDiagOperator(self.base.with_compute_dtype(compute_dtype), self.sigma2)

    def fused_cg_step_fn(self, sigma2=None):
        """Fold this diagonal into the base kernel's σ² tile term (the fused
        kernel adds it at global row == column, so the fused step IS K̂·D).
        A batched σ² has no scalar tile term: None, the unfused loop — with
        one warning per operator where the base has a fused step to give
        up."""
        s2 = torch.as_tensor(self.sigma2)
        if s2.dim():
            if type(self.base).fused_cg_step_fn is not LinearOperator.fused_cg_step_fn:
                _warn_once_per_op(
                    self,
                    "added_diag_batched_sigma2",
                    "fuse_cg=True with batched (per-model) noise: the fused kernel "
                    "folds one scalar σ² into its diagonal tile, so batched σ² runs "
                    "the unfused mBCG loop instead.",
                )
            return None
        if sigma2 is not None:
            s2 = s2 + sigma2
        return self.base.fused_cg_step_fn(sigma2=s2)


_FUSED_FALLBACK_WARNED: dict = {}


def _warn_once_per_op(op, key: str, message: str) -> None:
    """Warn once per operator construction, not once per solve.

    ``fused_cg_step_fn`` is asked on every engine solve, and ``prepare()``
    rebuilds fresh operator objects each time, so the dedup token is the
    identity (and shape) of the operator's tensor leaves: every re-prepared
    copy of one user-built operator shares them, a new operator (new
    parameter tensors) warns afresh."""
    leaves = tensor_leaves(op)
    token = (key, tuple(id(x) for x in leaves) or id(op), tuple(tuple(x.shape) for x in leaves))
    if token in _FUSED_FALLBACK_WARNED:
        return
    if len(_FUSED_FALLBACK_WARNED) > 4096:
        _FUSED_FALLBACK_WARNED.clear()
    _FUSED_FALLBACK_WARNED[token] = True
    warnings.warn(message, stacklevel=4)


@dataclasses.dataclass(frozen=True)
class BatchDenseOperator(LinearOperator):
    """Stack of b independent dense blocks (a block-diagonal view) — the
    multi-restart path's b kernel matrices.  ``shape`` is one block's;
    ``matmul`` takes (b, n, t) (or anything broadcasting against it).

    ``compute_dtype="bfloat16"`` rounds both operands to bf16 and
    accumulates in f32, as :class:`DenseOperator`.

    ``diag`` is the blocks' exact diagonal where the caller knows it (a
    stationary kernel's k(x, x)); the pivoted-Cholesky preconditioner
    pivots on it, as it pivots on ``KernelOperator.diagonal()`` for one
    hyperparameter set, so a batch and a loop pick the same pivots.  The
    materialized diagonal carries the distance's rounding, which breaks
    k(x, x)'s ties at random.  Without it, the matrices' diagonal."""

    matrices: torch.Tensor  # (b, n, n)
    compute_dtype: str = "float32"
    diag: torch.Tensor | None = None  # (b, n)

    @property
    def shape(self):
        return tuple(self.matrices.shape[-2:])

    @property
    def batch(self) -> int:
        return self.matrices.shape[0]

    @property
    def dtype(self):
        return self.matrices.dtype

    @property
    def device(self):
        return self.matrices.device

    def matmul(self, M):
        if is_reduced(self.compute_dtype):
            return _mixed_matmul(self.matrices, M)
        return self.matrices @ M

    def with_compute_dtype(self, compute_dtype):
        return dataclasses.replace(self, compute_dtype=normalize_compute_dtype(compute_dtype))

    def diagonal(self):
        if self.diag is not None:
            return self.diag
        return torch.diagonal(self.matrices, dim1=-2, dim2=-1)

    def to_dense(self):
        return self.matrices


# --- multitask (Kronecker / Hadamard) operators -------------------------------


def _warn_unfused_kronecker(op):
    _warn_once_per_op(
        op,
        "kronecker_unfused",
        "fuse_cg=True requested on a Kronecker-structured operator: the "
        "Kronecker CG step has no fused kernel (the task contraction sits "
        "between the state update and the tile product) — falling back to "
        "the unfused mBCG loop.  The data-kernel matmul inside each "
        "iteration still runs the prepared kernel path.",
    )


def _as_columns(M: torch.Tensor):
    """(M as (…, rows, t), whether it was a vector)."""
    return (M[:, None], True) if M.dim() == 1 else (M, False)


@dataclasses.dataclass(frozen=True)
class KroneckerKernelOperator(LinearOperator):
    """K_X ⊗ K_T — the multitask covariance over a complete task grid.

    Rows are data-major: global row i·T + τ is (data point i, task τ), so
    (K_X ⊗ K_T)[iT+τ, jT+τ'] = K_X[i, j]·K_T[τ, τ'].  ``matmul`` is ONE
    data-kernel call: the (n·T, t) right-hand side viewed as an (n, T·t)
    block (a view where it is contiguous) goes through ``data_op.matmul``
    — on the card one kernel-matrix launch at T·t columns — and the result
    is contracted against the small (T, T) task kernel in f32, whatever
    the data operator's precision: O(t·(n²T + nT²))."""

    data_op: LinearOperator  # (n, n) — any data-kernel operator
    task: torch.Tensor  # (T, T) symmetric PSD task kernel

    @property
    def shape(self):
        nT = self.data_op.shape[0] * self.task.shape[0]
        return (nT, nT)

    @property
    def num_tasks(self) -> int:
        return self.task.shape[0]

    @property
    def dtype(self):
        return self.data_op.dtype

    @property
    def device(self):
        return self.data_op.device

    def matmul(self, M):
        M, squeeze = _as_columns(M)
        T = self.task.shape[0]
        n = self.data_op.shape[0]
        t = M.shape[-1]
        batch = M.shape[:-2]
        block = M.reshape(*batch, n, T * t)  # row iT+τ → (i, τ·t + column)
        Y = self.data_op.matmul(block).reshape(*batch, n, T, t)
        out = torch.einsum("st,...utc->...usc", self.task, Y).reshape(*batch, n * T, t)
        return out[..., 0] if squeeze else out

    def diagonal(self):
        return torch.outer(self.data_op.diagonal(), torch.diagonal(self.task)).reshape(-1)

    def row(self, i):
        T = self.task.shape[0]
        return torch.outer(self.data_op.row(i // T), self.task[i % T]).reshape(-1)

    def prepare(self):
        return KroneckerKernelOperator(self.data_op.prepare(), self.task)

    def with_compute_dtype(self, compute_dtype):
        # the O(n²·Tt) data matmul takes the policy; the (T, T) task
        # contraction stays f32
        return KroneckerKernelOperator(self.data_op.with_compute_dtype(compute_dtype), self.task)

    def fused_cg_step_fn(self, sigma2=None):
        """No fused step: warns once per operator and returns None (the
        unfused loop)."""
        _warn_unfused_kronecker(self)
        return None


@dataclasses.dataclass(frozen=True)
class HadamardKroneckerOperator(LinearOperator):
    """The multitask covariance of a heterogeneous panel: each of the m rows
    is one (data point, task) observation with its ``task_ids[i]``, and

        K[i, j] = K_X[i, j] · K_T[task_ids[i], task_ids[j]].

    ``matmul`` keeps the one-data-matmul structure: the right-hand side is
    scattered into per-task slots (one-hot on the task id), the (m, T·t)
    block makes ONE ``data_op.matmul`` call, and the task-kernel rows
    gathered by task id contract the result.  On a complete data-major
    grid it equals :class:`KroneckerKernelOperator` entry for entry."""

    data_op: LinearOperator  # (m, m) over the rows' data coordinates
    task: torch.Tensor  # (T, T)
    task_ids: torch.Tensor  # (m,) int64 task of each row (never differentiated)

    @property
    def shape(self):
        m = self.data_op.shape[0]
        return (m, m)

    @property
    def num_tasks(self) -> int:
        return self.task.shape[0]

    @property
    def dtype(self):
        return self.data_op.dtype

    @property
    def device(self):
        return self.data_op.device

    def matmul(self, M):
        M, squeeze = _as_columns(M)
        T = self.task.shape[0]
        m = self.data_op.shape[0]
        t = M.shape[-1]
        batch = M.shape[:-2]
        onehot = torch.nn.functional.one_hot(self.task_ids, T).to(M.dtype)  # (m, T)
        expanded = (onehot[:, :, None] * M[..., :, None, :]).reshape(*batch, m, T * t)
        Y = self.data_op.matmul(expanded).reshape(*batch, m, T, t)
        rows = self.task[self.task_ids]  # (m, T) gathered task-kernel rows
        out = torch.sum(rows[:, :, None] * Y, dim=-2)
        return out[..., 0] if squeeze else out

    def diagonal(self):
        return self.data_op.diagonal() * torch.diagonal(self.task)[self.task_ids]

    def row(self, i):
        return self.data_op.row(i) * self.task[self.task_ids[i]][self.task_ids]

    def prepare(self):
        return HadamardKroneckerOperator(self.data_op.prepare(), self.task, self.task_ids)

    def with_compute_dtype(self, compute_dtype):
        return HadamardKroneckerOperator(
            self.data_op.with_compute_dtype(compute_dtype), self.task, self.task_ids
        )

    def fused_cg_step_fn(self, sigma2=None):
        _warn_unfused_kronecker(self)
        return None


@dataclasses.dataclass(frozen=True)
class KroneckerAddedDiagOperator(LinearOperator):
    """K̂ = K_multitask + Σ_noise with per-task noise σ²_τ.

    In the data-major Kronecker layout the noise is I_n ⊗ diag(σ²) (row
    i·T + τ gets σ²_τ); over a Hadamard base it is the gather
    σ²_{task_ids[i]}.  ``task_ids=None`` selects the tiled grid layout.
    ``diagonal()`` is exact, which keeps cached Rayleigh–Ritz variances
    conservative; ``with_compute_dtype`` recurses into the base while the
    noise stays f32."""

    base: LinearOperator  # Kronecker or Hadamard multitask kernel
    task_noise: torch.Tensor  # (T,) per-task σ²_τ (scalar = shared)
    task_ids: torch.Tensor | None = None  # (m,) int64, None → tiled grid layout

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def device(self):
        return self.base.device

    def _row_noise(self):
        noise = torch.as_tensor(self.task_noise)
        m = self.base.shape[0]
        if noise.dim() == 0:
            return noise.expand(m)
        if self.task_ids is None:
            return noise.repeat(m // noise.shape[0])
        return noise[self.task_ids]

    def matmul(self, M):
        noise = self._row_noise()
        if M.dim() == 1:
            return self.base.matmul(M) + noise * M
        return self.base.matmul(M) + noise[:, None] * M

    def diagonal(self):
        return self.base.diagonal() + self._row_noise()

    def row(self, i):
        r = self.base.row(i).clone()
        r[i] += self._row_noise()[i]
        return r

    def prepare(self):
        return KroneckerAddedDiagOperator(self.base.prepare(), self.task_noise, self.task_ids)

    def with_compute_dtype(self, compute_dtype):
        # the noise stays f32 — only the multitask kernel matmul reduces
        return KroneckerAddedDiagOperator(
            self.base.with_compute_dtype(compute_dtype), self.task_noise, self.task_ids
        )

    def fused_cg_step_fn(self, sigma2=None):
        _warn_unfused_kronecker(self)
        return None


# --- SKI's structured operators and the blackbox operator ------------------


@dataclasses.dataclass(frozen=True)
class ToeplitzOperator(LinearOperator):
    """Symmetric Toeplitz matrix defined by its first column (m,) — the SKI /
    KISS-GP K_UU along one regular grid axis (paper §5).

    ``matmul`` is the circulant embedding of size 2m through ``torch.fft``
    (rfft / irfft, cuFFT on the card): O(t·m log m), in f32 for f32 and
    bf16 operands alike (f64 ones, a witness's, stay f64).  The embedding
    is numerically unsafe at bf16, so ``with_compute_dtype`` keeps the
    default no-op under "mixed"."""

    column: torch.Tensor  # (m,)

    @property
    def shape(self):
        m = self.column.shape[0]
        return (m, m)

    @property
    def dtype(self):
        return self.column.dtype

    @property
    def device(self):
        return self.column.device

    def matmul(self, M):
        M, squeeze = _as_columns(M)
        m = self.column.shape[0]
        dtype = torch.promote_types(torch.promote_types(self.column.dtype, M.dtype), torch.float32)
        col = self.column.to(dtype)
        # [c0 c1 … c_{m−1} 0 c_{m−1} … c1]
        circulant = torch.cat([col, col.new_zeros(1), col[1:].flip(0)])
        spectrum = torch.fft.rfft(circulant)
        fM = torch.fft.rfft(M.to(dtype), n=2 * m, dim=-2)
        out = torch.fft.irfft(spectrum[:, None] * fM, n=2 * m, dim=-2)[..., :m, :].to(M.dtype)
        return out[..., 0] if squeeze else out

    def diagonal(self):
        return self.column[:1].repeat(self.column.shape[0])

    def row(self, i):
        m = self.column.shape[0]
        return self.column[torch.abs(torch.arange(m, device=self.column.device) - i)]

    def entries(self, a, b):
        return self.column[torch.abs(a - b)]

    def to_dense(self):
        idx = torch.arange(self.column.shape[0], device=self.column.device)
        return self.column[torch.abs(idx[:, None] - idx[None, :])]


@dataclasses.dataclass(frozen=True)
class KroneckerOperator(LinearOperator):
    """K₁ ⊗ K₂ ⊗ … — the K_UU of a multi-dimensional SKI grid, row-major
    (the last factor's index varies fastest).  ``matmul`` applies each
    factor along its own grid axis: O(t·m·Σmᵢ) instead of O(t·m²) for
    m = Πmᵢ."""

    factors: tuple  # of LinearOperators

    @property
    def shape(self):
        m = 1
        for f in self.factors:
            m *= f.shape[0]
        return (m, m)

    @property
    def dtype(self):
        return self.factors[0].dtype

    @property
    def device(self):
        return self.factors[0].device

    def _dims(self) -> list[int]:
        return [f.shape[0] for f in self.factors]

    def _split(self, i):
        """Row-major index i (an int or an integer tensor) → one index per
        factor."""
        idxs = []
        for m in reversed(self._dims()):
            idxs.append(i % m)
            i = i // m
        return idxs[::-1]

    def matmul(self, M):
        M, squeeze = _as_columns(M)
        t = M.shape[-1]
        dims = self._dims()
        out = M.reshape(*dims, t)
        for i, f in enumerate(self.factors):  # factor i contracts grid axis i
            moved = out.movedim(i, 0)
            rest = moved.shape[1:]
            out = f.matmul(moved.reshape(dims[i], -1)).reshape(dims[i], *rest).movedim(0, i)
        out = out.reshape(-1, t)
        return out[:, 0] if squeeze else out

    def diagonal(self):
        d = self.factors[0].diagonal()
        for f in self.factors[1:]:
            d = torch.outer(d, f.diagonal()).reshape(-1)
        return d

    def row(self, i):
        idxs = self._split(i)
        r = self.factors[0].row(idxs[0])
        for f, j in zip(self.factors[1:], idxs[1:]):
            r = torch.outer(r, f.row(j)).reshape(-1)
        return r

    def entries(self, a, b):
        out = None
        for f, ai, bi in zip(self.factors, self._split(a), self._split(b)):
            e = f.entries(ai, bi)
            out = e if out is None else out * e
        return out

    def with_compute_dtype(self, compute_dtype):
        return KroneckerOperator(tuple(f.with_compute_dtype(compute_dtype) for f in self.factors))


def interpolation_order(indices: torch.Tensor, m: int):
    """The fixed summation order of Wᵀ for a sparse W (n × m) held as
    ``indices`` (n, q): (``order``, ``offsets``) — ``order`` (n·q,) the flat
    positions sorted by grid index (a stable sort: each grid point keeps its
    terms in row order), ``offsets`` (m + 1,) each grid point's segment of
    it.  A CSR of Wᵀ; it depends on the data alone, so SKI builds it once."""
    flat = indices.reshape(-1)
    order = torch.argsort(flat, stable=True)
    offsets = torch.searchsorted(flat[order], torch.arange(m + 1, device=flat.device))
    return order, offsets


def _w_product(V, indices, values):
    """W·V (n, t): each row's q terms added in tap order."""
    out = values[:, :1] * V[indices[:, 0]]
    for k in range(1, indices.shape[1]):
        out.addcmul_(values[:, k:k + 1], V[indices[:, k]])
    return out


def _wt_product(M, values, order, offsets):
    """Wᵀ·M (m, t): each grid point's terms added in the order of
    :func:`interpolation_order` (``torch.segment_reduce``: one sequential
    sum per segment, no atomics)."""
    q = values.shape[1]
    terms = values.reshape(-1)[order, None] * M[order // q]
    return torch.segment_reduce(terms, "sum", offsets=offsets, axis=0, unsafe=True, initial=0.0)


class _WMatmulFn(torch.autograd.Function):
    """W·V; its backward is Wᵀ·G (:class:`_WtMatmulFn`) — autograd's own
    backward of the gather would scatter-add with atomics."""

    @staticmethod
    def forward(ctx, V, values, indices, order, offsets):
        ctx.save_for_backward(V, values, indices, order, offsets)
        return _w_product(V, indices, values)

    @staticmethod
    def backward(ctx, G):
        V, values, indices, order, offsets = ctx.saved_tensors
        dV = dvalues = None
        if ctx.needs_input_grad[0]:
            dV = _WtMatmulFn.apply(G, values, indices, order, offsets)
        if ctx.needs_input_grad[1]:
            dvalues = torch.stack(
                [(G * V[indices[:, k]]).sum(-1) for k in range(indices.shape[1])], dim=1)
        return dV, dvalues, None, None, None


class _WtMatmulFn(torch.autograd.Function):
    """Wᵀ·M; its backward is W·G (:class:`_WMatmulFn`)."""

    @staticmethod
    def forward(ctx, M, values, indices, order, offsets):
        ctx.save_for_backward(M, values, indices, order, offsets)
        return _wt_product(M, values, order, offsets)

    @staticmethod
    def backward(ctx, G):
        M, values, indices, order, offsets = ctx.saved_tensors
        dM = dvalues = None
        if ctx.needs_input_grad[0]:
            dM = _WMatmulFn.apply(G, values, indices, order, offsets)
        if ctx.needs_input_grad[1]:
            dvalues = torch.stack(
                [(G[indices[:, k]] * M).sum(-1) for k in range(indices.shape[1])], dim=1)
        return dM, dvalues, None, None, None


@dataclasses.dataclass(frozen=True)
class InterpolatedOperator(LinearOperator):
    """W·K_base·Wᵀ with a sparse interpolation W (n × m, q nonzeros a row)
    held as (``indices``, ``values``) of shape (n, q) — SKI.  ``matmul``
    costs O(t·n·q) for the interpolations plus one base product: with a
    Toeplitz base the paper's O(t·n + t·m log m).

    Deterministic on the card: W·V adds each row's terms in tap order, Wᵀ·M
    each grid point's in the fixed order of :func:`interpolation_order`
    (``order`` / ``offsets``; ``prepare`` computes them when not given), and
    each is the other's backward — no atomic scatter-add, so two builds or
    two gradients give the same bits.  ``diagonal`` reads the n·q² base
    entries it needs directly (``entries``), never a row of length m per
    entry.  ``with_compute_dtype`` recurses into the base only: the
    interpolations stay f32."""

    indices: torch.Tensor  # (n, q) int64 grid index of each nonzero
    values: torch.Tensor  # (n, q) interpolation weights
    base: LinearOperator  # (m, m)
    order: torch.Tensor | None = None  # (n·q,) Wᵀ's summation order
    offsets: torch.Tensor | None = None  # (m + 1,) its segments

    @property
    def shape(self):
        n = self.indices.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    def _csr(self):
        if self.order is None:
            return interpolation_order(self.indices, self.base.shape[0])
        return self.order, self.offsets

    def _W_matmul(self, V):
        """W·V: (n, t)."""
        return _WMatmulFn.apply(_as_columns(V)[0], self.values, self.indices, *self._csr())

    def _Wt_matmul(self, M):
        """Wᵀ·M: (m, t)."""
        return _WtMatmulFn.apply(_as_columns(M)[0], self.values, self.indices, *self._csr())

    def matmul(self, M):
        M, squeeze = _as_columns(M)
        out = self._W_matmul(self.base.matmul(self._Wt_matmul(M)))
        return out[:, 0] if squeeze else out

    def row(self, i):
        # (W K Wᵀ)[i, :] = W·(K·wᵢ), wᵢ row i of W as an m-vector
        m = self.base.shape[0]
        taps = torch.nn.functional.one_hot(self.indices[i], m).to(self.values.dtype)
        w = (taps * self.values[i][:, None]).sum(0)
        return self._W_matmul(self.base.matmul(w[:, None]))[:, 0]

    def diagonal(self):
        # diag_i = wᵢ·K[taps, taps]·wᵢᵀ over the q × q block at row i's taps
        q = self.indices.shape[1]
        sub = self.base.entries(self.indices[:, :, None].expand(-1, -1, q),
                                self.indices[:, None, :].expand(-1, q, -1))
        return torch.einsum("nq,nqr,nr->n", self.values, sub, self.values)

    def prepare(self):
        order, offsets = self._csr()
        return dataclasses.replace(self, base=self.base.prepare(), order=order, offsets=offsets)

    def with_compute_dtype(self, compute_dtype):
        return dataclasses.replace(self, base=self.base.with_compute_dtype(compute_dtype))


@dataclasses.dataclass(frozen=True)
class CallableOperator(LinearOperator):
    """Fully blackbox operator: the user's ``matmul_fn(params, M)`` and,
    optionally, ``row_fn(params, i)`` and ``diag_fn(params)`` (else the
    defaults through ``matmul``).  ``params`` — a tensor, or a dict or list
    of tensors — is passed to every callback; its tensors are the operator's
    leaves, so the MLL's gradient reaches each of them."""

    params: Any
    matmul_fn: Callable
    row_fn: Callable | None = None
    diag_fn: Callable | None = None
    n: int = 0
    _dtype: torch.dtype = torch.float32

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        leaves = tensor_leaves(self.params)
        return leaves[0].device if leaves else torch.device("cpu")

    def matmul(self, M):
        return self.matmul_fn(self.params, M)

    def row(self, i):
        if self.row_fn is None:
            return super().row(i)
        return self.row_fn(self.params, i)

    def diagonal(self):
        if self.diag_fn is None:
            return super().diagonal()
        return self.diag_fn(self.params)


# --- partitioned kernel streaming (million-row exact GPs) -------------------


@dataclasses.dataclass(frozen=True)
class PanelLaunch:
    """Accounting record for one partitioned ``matmul`` or panel-fused CG
    step.

    The port runs eagerly, so there is one record per CALL — each CG
    iteration of a partitioned solve records its own — where the
    reference, which traces, records one per traced matmul (a matmul in a
    CG scan traced once).  The memory contract it carries: no panel is the
    full height, ``panel_rows < n``.  Sharded over ``devices`` row bands,
    ``num_panels`` counts every band's panels (each rank launches its
    own)."""

    n: int
    rhs_cols: int
    batch: int
    panel_rows: int
    num_panels: int
    backend: str
    sharded: bool = False
    devices: int = 1
    itemsize: int = 4
    #: True for a panel-fused CG step (one fused launch per panel per
    #: iteration), False for a streamed matmul
    fused: bool = False

    @property
    def panel_bytes(self) -> int:
        """Working set of one streamed panel, as the reference counts it:
        the (p × n) kernel slab plus the panel's output rows.  The torch
        backend materializes the slab; the CUDA kernels never do (they hold
        64-row tiles in shared memory), so for them it is an upper bound."""
        return self.itemsize * self.panel_rows * (self.n + self.rhs_cols * max(self.batch, 1))

    @property
    def dense_bytes(self) -> int:
        """What materializing K in f32 would cost instead."""
        return 4 * self.n * self.n


_PANEL_SINK = threading.local()


@contextmanager
def panel_accounting(into=None):
    """Collect a :class:`PanelLaunch` for every partitioned matmul and
    panel-fused step called in the block (mirrors
    :func:`repro_torch.core.health.collect`).  Yields the list."""
    launches = [] if into is None else into
    prev = getattr(_PANEL_SINK, "launches", None)
    _PANEL_SINK.launches = launches
    try:
        yield launches
    finally:
        _PANEL_SINK.launches = prev


def _record_panels(launch: PanelLaunch) -> None:
    """Deliver one PanelLaunch to every installed sink.

    Three sinks, same record: the :func:`panel_accounting` list, the obs
    metrics registry (launch / byte counters), and the obs trace (one
    ``panel_launch`` span per record, so a trace's panel-span count equals
    ``panel_accounting()``'s list length by construction).  All are no-ops
    when nothing is installed."""
    sink = getattr(_PANEL_SINK, "launches", None)
    if sink is not None:
        sink.append(launch)
    if obs.active() is not None:
        labels = dict(backend=launch.backend, fused=str(launch.fused).lower(),
                      sharded=str(launch.sharded).lower())
        obs.inc("panel_matmuls_traced_total", **labels)
        obs.inc("panel_launches_traced_total", launch.num_panels, **labels)
        obs.inc("panel_bytes_streamed_total", launch.panel_bytes * launch.num_panels, **labels)
        obs.set_gauge("panel_rows", launch.panel_rows, backend=launch.backend)
    col = obs.active_trace()
    if col is not None:
        # a record per call: the span marks the launch, not a wall time
        col.add_complete("panel_launch", col.now_us(), 0.0, {
            "n": launch.n, "panel_rows": launch.panel_rows, "num_panels": launch.num_panels,
            "backend": launch.backend, "fused": launch.fused, "sharded": launch.sharded,
        })


def _panel_starts(rows: int, panel_rows: int) -> range:
    return range(0, rows, max(1, min(int(panel_rows), rows)))


def _torch_panel_matmul(kernel, X_rows, X_cols, M, panel_rows, *, compute_dtype):
    """K(X_rows, X_cols) @ M streamed one (panel_rows × n) slab at a time
    with the kernel evaluated by plain torch operations (the reference's
    ``_xla_panel_matmul``).  Each panel runs under
    ``torch.utils.checkpoint``, so the backward rematerializes one slab at
    a time instead of keeping every panel live.  The output is f32
    (…, rows, t)."""
    reduced = is_reduced(normalize_compute_dtype(compute_dtype))
    p = max(1, min(int(panel_rows), X_rows.shape[0]))
    Mf = M.to(torch.float32)

    def one_panel(Xpan):
        tile = kernel(Xpan, X_cols).to(torch.float32)
        return _mixed_matmul(tile, Mf) if reduced else tile @ Mf

    outs = [
        checkpoint(one_panel, X_rows[s : s + p], use_reentrant=False)
        for s in _panel_starts(X_rows.shape[0], p)
    ]
    return torch.cat(outs, dim=-2)


def _new_direction(R, D, V, alpha, beta, gamma):
    """This iteration's direction D₂ = γ∘(R − α∘V) + β∘D from the
    pre-update state (every row's, for the column side of a band)."""
    a = alpha[..., None, :]
    return gamma[..., None, :] * (R - a * V) + beta[..., None, :] * D


def _torch_panel_fused_step(kernel, X, U, R, D, V, alpha, beta, gamma, sigma2, panel_rows, *,
                            compute_dtype):
    """One CG iteration of K̂ = K(X, X) + σ²I streamed one (panel_rows × n)
    slab at a time with plain torch operations — the twin of
    :func:`repro_torch.kernels.kernel_matmul.ops.panel_fused_cg_step_prescaled`
    and of the reference's ``_xla_panel_fused_step``: the band
    (:func:`_torch_band_fused_step`) is every row."""
    return _torch_band_fused_step(kernel, X, X, U, R, D, V, _new_direction(R, D, V, alpha, beta,
                                                                           gamma),
                                  alpha, beta, gamma, sigma2, panel_rows,
                                  compute_dtype=compute_dtype)


def _torch_band_fused_step(kernel, X_band, X_cols, U, R, D, V, D2_cols, alpha, beta, gamma,
                           sigma2, panel_rows, *, compute_dtype):
    """One CG iteration over a contiguous row band (U, R, D, V its rows),
    streamed one (panel_rows × n) slab at a time with plain torch
    operations — the reference's ``_xla_band_fused_step``.

    The pending updates U += α∘D, R −= α∘V and the direction D₂ = γ∘R₂ +
    β∘D are elementwise over the band's rows; V₂ = K̂·D₂ takes one slab per
    panel against ``D2_cols``, the full new direction; the [dᵀV; rᵀr; rᵀV;
    vᵀV] partials are summed over each panel's rows and folded in panel
    order from zeros.  A last panel that does not divide runs at its own
    height.  Not checkpointed: MLL gradients go through the matmul, never
    through the fused step."""
    reduced = is_reduced(normalize_compute_dtype(compute_dtype))
    a, b, g = (s[..., None, :] for s in (alpha, beta, gamma))
    U2 = U + a * D
    R2 = R - a * V
    D2 = g * R2 + b * D
    Mc = D2_cols.to(torch.float32)
    s2 = torch.as_tensor(sigma2, dtype=torch.float32, device=U.device)
    red = [torch.zeros(U.shape[:-2] + U.shape[-1:], dtype=torch.float32, device=U.device)
           for _ in range(4)]
    Vs = []
    rows = X_band.shape[0]
    p = max(1, min(int(panel_rows), rows))
    for s in _panel_starts(rows, p):
        tile = kernel(X_band[s : s + p], X_cols).to(torch.float32)
        D2p, R2p = D2[..., s : s + p, :], R2[..., s : s + p, :]
        V2p = (_mixed_matmul(tile, Mc) if reduced else tile @ Mc) + s2 * D2p
        parts = ((D2p * V2p).sum(-2), (R2p * R2p).sum(-2), (R2p * V2p).sum(-2),
                 (V2p * V2p).sum(-2))
        red = [r + q for r, q in zip(red, parts)]
        Vs.append(V2p)
    return U2, R2, D2, torch.cat(Vs, dim=-2), tuple(red)


class _ShardedBandMatmulFn(torch.autograd.Function):
    """The full product from this rank's row band of it, with a
    band-sharded backward (the reference's ``_sharded_partitioned_matmul``
    custom VJP, for products evaluated by plain torch operations).

    ``band_fn(M, leaves)`` gives rows ``[start, stop)`` of the product from
    the right-hand side and the tensors it is differentiable in (X, the
    kernel's hyperparameters).  Forward: the band, without a graph, and one
    all-gather of the rows.  Backward: the cotangent is the full one, the
    same on every rank; each rank recomputes its band with a graph
    (checkpointed panels re-stream one slab at a time) and takes the
    vector-Jacobian product at its rows of the cotangent, and every
    gradient — the sum over the bands — is folded across ranks with
    :func:`repro_torch.distributed.sharding.ordered_psum`."""

    @staticmethod
    def forward(ctx, band_fn, band, mesh, axes, M, *leaves):
        ctx.band_fn, ctx.band, ctx.mesh, ctx.axes = band_fn, band, mesh, axes
        ctx.save_for_backward(M, *leaves)
        with torch.no_grad():
            return all_gather_rows(band_fn(M, list(leaves)), mesh, axes)

    @staticmethod
    def backward(ctx, C):
        need = ctx.needs_input_grad[4:]
        inputs = [x.detach().requires_grad_(nd) for x, nd in zip(ctx.saved_tensors, need)]
        wanted = [x for x in inputs if x.requires_grad]
        grads = [None] * len(inputs)
        if wanted:
            start, stop = ctx.band
            with torch.enable_grad():
                out = ctx.band_fn(inputs[0], inputs[1:])
                got = torch.autograd.grad(out, wanted, C[..., start:stop, :], allow_unused=True)
            it = iter(got)
            for i, x in enumerate(inputs):
                if x.requires_grad:
                    g = next(it)
                    grads[i] = ordered_psum(torch.zeros_like(x) if g is None else g,
                                            ctx.mesh, ctx.axes)
        return (None, None, None, None, *grads)


class _PartitionedMatmulFn(torch.autograd.Function):
    """K(X, X)·M for pre-scaled X, streamed one row-panel at a time through
    the kernel wrappers (one B1/B2 launch per panel with the panel's
    ``row_offset``), differentiable in Xs, M and the outputscale — the
    counterpart of the reference's ``_partitioned_matmul`` custom VJP.

    Backward: for Xs and the outputscale, one gradient-kernel launch per
    panel (:func:`repro_torch.kernels.kernel_matmul.ops.panel_vjp_prescaled`:
    the panel's rows against all columns, with the symmetric weight
    [C | M]ᵢ·[M | C]ⱼ, so each launch gives its rows' complete gradient),
    the rows written in place and the outputscale's partial sums folded in
    panel order; for M, the same panel stream on the cotangent (K is
    symmetric).  No more than one panel is in flight.  On CPU tensors the
    wrappers run their plain versions."""

    @staticmethod
    def forward(ctx, Xs, M, outputscale, panel_rows, kernel_type):
        from repro_torch.kernels.kernel_matmul.ops import panel_matmul_prescaled

        ctx.save_for_backward(Xs, M, outputscale)
        ctx.panel_rows, ctx.kernel_type = panel_rows, kernel_type
        return panel_matmul_prescaled(Xs, M, outputscale, panel_rows, kernel_type=kernel_type)

    @staticmethod
    def backward(ctx, C):
        from repro_torch.kernels.kernel_matmul.ops import (
            panel_matmul_prescaled,
            panel_vjp_prescaled,
        )

        Xs, M, s = ctx.saved_tensors
        need = ctx.needs_input_grad
        p, kt = ctx.panel_rows, ctx.kernel_type
        gXs = gM = gs = None
        if need[0] or need[2]:
            gXs, gs = panel_vjp_prescaled(Xs, M, C, s, p, kernel_type=kt)
            gs = gs.reshape(s.shape)
        if need[1]:
            gM = panel_matmul_prescaled(Xs, C, s, p, kernel_type=kt)
        return gXs, gM, gs, None, None


@dataclasses.dataclass(frozen=True)
class PartitionedKernelOperator(LinearOperator):
    """K(X, X) streamed one (panel_rows × n) row-panel at a time — the
    operator that makes "n is bounded by O(n²) memory" false (Wang et al.
    2019, "Exact Gaussian Processes on a Million Data Points").  Peak
    memory is O(n·(d + t)) state plus one panel's working set.

    Backends (``backend=``):

      * ``"cuda"``  — one kernel launch per panel on pre-scaled inputs with
        the panel's global ``row_offset`` (B1/B2; the fused step B3; the
        gradient kernel in the backward, :class:`_PartitionedMatmulFn`).
        The kernels never form a (panel_rows × n) slab, so the default
        height comes from the card (``ops.cuda_panel_rows``, whole waves of
        row blocks on its SMs), not from a byte budget.  On CPU tensors the
        wrappers run their plain versions, which do form the slab, so
        there the default is the reference's byte-budget chooser.
      * ``"torch"`` — the kernel evaluated by plain torch operations, one
        slab per panel under ``torch.utils.checkpoint`` (the reference's
        ``"xla"`` backend).
      * ``"auto"``  — ``"cuda"`` for a CUDA X, ``"torch"`` otherwise.

    ``row()`` / ``diagonal()`` are exact O(n·d) primitives for the
    pivoted-Cholesky preconditioner.

    Multi-device: when ``data_axes`` names axes of a mesh (the ``mesh``
    field, else the ambient :func:`repro_torch.distributed.use_mesh`), each
    rank streams the panels of its own row band ``[i·n/S, (i+1)·n/S)`` at
    their global ``row_offset`` and the bands are all-gathered (every rank
    passes and gets the full operands).  The backward is band-sharded
    (each rank re-streams its band's gradient panels; the cuda backend
    through :class:`repro_torch.kernels.kernel_matmul.ops.ShardedMatmulFn`,
    the torch one through :class:`_ShardedBandMatmulFn`), and the
    panel-fused step folds its reductions across bands with
    ``ordered_psum``, so with one panel per band a sharded fused solve is
    the single-device one bit for bit.  An n the bands do not divide runs
    single-device, with a warning; ``data_axes=()`` never shards."""

    kernel: Any  # stationary kernel (RBF / Matérn: __call__ and diag)
    X: torch.Tensor  # (n, d) raw inputs
    Xs: torch.Tensor | None = None  # prepare()-cached pre-scaled inputs (cuda backend)
    kernel_type: str = "rbf"
    panel_rows: int = 0  # 0 → the backend's default (cuda) or the budget chooser
    panel_budget_bytes: int = 0  # 0 → ops.PANEL_BUDGET_BYTES
    backend: str = "auto"  # auto | cuda | torch
    data_axes: tuple = ("data",)  # mesh axes the rows are sharded over
    mesh: Any = None  # explicit mesh (else the ambient one)
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.backend not in ("auto", "cuda", "torch"):
            raise ValueError(f"backend must be 'auto', 'cuda' or 'torch', got {self.backend!r}")

    @property
    def shape(self):
        n = self.X.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return torch.float32  # panels accumulate in f32

    @property
    def device(self):
        return self.X.device

    @property
    def resolved_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        return "cuda" if self.X.device.type == "cuda" else "torch"

    @property
    def _itemsize(self) -> int:
        return 2 if is_reduced(self.compute_dtype) else 4

    def panel_rows_for(self, n: int, *, rhs_cols: int = 0, batch: int = 1,
                       fused: bool = False) -> int:
        """The panel height: the explicit ``panel_rows``; else, on the cuda
        backend with X on the card and no byte budget, the card's default
        (:func:`~repro_torch.kernels.kernel_matmul.ops.cuda_panel_rows` on
        its SM count); else the reference's byte-budget chooser (``fused``
        budgets the fused step's state slabs too)."""
        from repro_torch.kernels.kernel_matmul.ops import choose_panel_rows, cuda_panel_rows

        if self.panel_rows > 0:
            p = self.panel_rows
        elif (self.resolved_backend == "cuda" and self.X.device.type == "cuda"
              and self.panel_budget_bytes <= 0):
            sms = torch.cuda.get_device_properties(self.X.device).multi_processor_count
            p = cuda_panel_rows(n, sms)
        else:
            p = choose_panel_rows(
                n, budget_bytes=self.panel_budget_bytes or None, itemsize=self._itemsize,
                rhs_cols=rhs_cols, batch=batch, fused=fused,
            )
        return max(1, min(p, n))

    def _live_mesh(self):
        """The mesh this operator shards over, or None (single-device)."""
        if self.mesh is not None:
            return self.mesh
        if not self.data_axes:
            return None
        mesh = current_mesh()
        if mesh is None or any(a not in mesh.axis_names for a in self.data_axes):
            return None
        return mesh

    def _sharding(self, what: str):
        """(mesh, shards) for this call: (None, 1) single-device, also —
        with one warning per operator — when the shards do not divide n."""
        mesh = self._live_mesh()
        shards = 1 if mesh is None else mesh.num_shards(tuple(self.data_axes))
        n = self.shape[0]
        if shards > 1 and n % shards:
            _warn_once_per_op(self, f"partitioned_indivisible_{what}",
                              f"partitioned {what}: n={n} not divisible by {shards} row "
                              "shards; running single-device")
            return None, 1
        return (mesh, shards) if shards > 1 else (None, 1)

    def _record(self, rhs_cols, batch, p, fused, shards=1):
        n = self.shape[0]
        _record_panels(PanelLaunch(
            n=n, rhs_cols=rhs_cols, batch=batch, panel_rows=p,
            num_panels=shards * -(-(n // shards) // p), backend=self.resolved_backend,
            sharded=shards > 1, devices=shards, itemsize=self._itemsize, fused=fused,
        ))

    def matmul(self, M):
        squeeze = M.dim() == 1
        if squeeze:
            M = M[:, None]
        op = self._ready()
        n = op.shape[0]
        mesh, shards = op._sharding("matmul")
        p = min(op.panel_rows_for(n), n // shards)
        op._record(M.shape[-1], _batch_size(M), p, False, shards)
        out = op._forward_matmul(M, p, mesh)
        return out[..., 0] if squeeze else out

    def _ready(self) -> "PartitionedKernelOperator":
        if self.resolved_backend == "cuda" and self.Xs is None:
            return self.prepare()
        return self

    def _forward_matmul(self, M, p, mesh=None):
        if mesh is not None:
            return self._sharded_matmul(M, p, mesh)
        if self.resolved_backend == "torch":
            return _torch_panel_matmul(self.kernel, self.X, self.X, M, p,
                                       compute_dtype=self.compute_dtype)
        M = M.to(torch.float32).contiguous()
        if is_reduced(self.compute_dtype):
            # the bf16 stream carries no gradient: the MLL's backward
            # differentiates the f32 operator
            from repro_torch.kernels.kernel_matmul.ops import panel_matmul_prescaled

            with torch.no_grad():
                return panel_matmul_prescaled(
                    self.Xs, M, self.kernel.outputscale, p,
                    kernel_type=self.kernel_type, compute_dtype=self.compute_dtype,
                )
        s = torch.as_tensor(self.kernel.outputscale, dtype=torch.float32, device=M.device)
        return _PartitionedMatmulFn.apply(self.Xs, M, s.reshape(()), p, self.kernel_type)

    def _sharded_matmul(self, M, p, mesh):
        """The band-sharded panel stream over ``mesh`` (the reference's
        ``_sharded_panel_matmul`` with its band-sharded VJP)."""
        axes = tuple(self.data_axes)
        if self.resolved_backend == "cuda":
            from repro_torch.kernels.kernel_matmul.ops import sharded_kernel_matmul_prescaled

            return sharded_kernel_matmul_prescaled(
                self.Xs, M, self.kernel.outputscale, mesh, axes, panel_rows=p,
                kernel_type=self.kernel_type, compute_dtype=self.compute_dtype,
            )
        start, stop = row_band(self.shape[0], mesh, axes)
        kernel, compute_dtype = self.kernel, self.compute_dtype

        def band_fn(m, leaves):
            X, kern = leaves[0], replace_tensor_leaves(kernel, leaves[1:])
            return _torch_panel_matmul(kern, X[start:stop], X, m, p, compute_dtype=compute_dtype)

        return _ShardedBandMatmulFn.apply(band_fn, (start, stop), mesh, axes, M, self.X,
                                          *tensor_leaves(kernel))

    def diagonal(self):
        return self.kernel.diag(self.X).to(torch.float32)

    def row(self, i):
        return self.kernel(self.X[i][None, :], self.X)[0].to(torch.float32)

    def prepare(self):
        """The cuda backend's per-solve work: X/ℓ (bf16-rounded under a
        bf16 ``compute_dtype``) and the kernel-type code; the torch backend
        has none.  Under grad mode Xs keeps its graph to the lengthscale."""
        if self.Xs is not None or self.resolved_backend != "cuda":
            return self
        from repro_torch.kernels.kernel_matmul.ops import prescale_inputs, stationary_kernel_type

        return dataclasses.replace(
            self,
            Xs=prescale_inputs(self.X, self.kernel.lengthscale, self.compute_dtype),
            kernel_type=stationary_kernel_type(self.kernel),
        )

    def with_compute_dtype(self, compute_dtype):
        compute_dtype = normalize_compute_dtype(compute_dtype)
        if compute_dtype == self.compute_dtype:
            return self
        # drop the prescale cache: it was rounded for the old dtype
        return dataclasses.replace(self, compute_dtype=compute_dtype, Xs=None)

    def fused_cg_step_fn(self, sigma2=None):
        """The panel-fused CG step: one fused launch per (panel_rows × n)
        row-panel per iteration (B3 with the panel's ``row_offset``; the
        column state is the full pre-update R, D, V for every panel), the
        [dᵀV; rᵀr; rᵀV; vᵀV] reductions folded across panels in panel
        order.  A batched σ² has no scalar tile term: one warning per
        operator, then None (the unfused streamed loop).

        Sharded, each rank streams its own band through the fused step
        (panels no taller than the band) and the reductions are folded
        across bands in shard order: with one panel per band the result is
        the single-device step's, bit for bit."""
        s2 = torch.zeros((), device=self.X.device) if sigma2 is None else torch.as_tensor(sigma2)
        if s2.dim():
            _warn_once_per_op(
                self,
                "partitioned_batched_sigma2",
                "fuse_cg=True on the partitioned path with batched noise: the fused "
                "kernel folds one scalar σ² into its diagonal tile — running the "
                "unfused streamed loop.",
            )
            return None
        op = self._ready()
        n = op.shape[0]
        mesh, shards = op._sharding("fused step")

        def step(U, R, D, V, alpha, beta, gamma):
            t, b = U.shape[-1], _batch_size(U)
            p = min(op.panel_rows_for(n, rhs_cols=t, batch=b, fused=True), n // shards)
            op._record(t, b, p, True, shards)
            if mesh is not None and op.resolved_backend == "torch":
                return _sharded_torch_fused_step(op, U, R, D, V, alpha, beta, gamma, s2, p, mesh)
            if mesh is not None:
                from repro_torch.kernels.kernel_matmul.ops import sharded_fused_cg_step_prescaled

                return sharded_fused_cg_step_prescaled(
                    op.Xs, U, R, D, V, alpha, beta, gamma, op.kernel.outputscale, s2, mesh,
                    op.data_axes, panel_rows=p, kernel_type=op.kernel_type,
                    compute_dtype=op.compute_dtype,
                )
            if op.resolved_backend == "torch":
                return _torch_panel_fused_step(op.kernel, op.X, U, R, D, V, alpha, beta, gamma,
                                               s2, p, compute_dtype=op.compute_dtype)
            from repro_torch.kernels.kernel_matmul.ops import panel_fused_cg_step_prescaled

            return panel_fused_cg_step_prescaled(
                op.Xs, U, R, D, V, alpha, beta, gamma, op.kernel.outputscale, s2,
                panel_rows=p, kernel_type=op.kernel_type, compute_dtype=op.compute_dtype,
            )

        return step


def _sharded_torch_fused_step(op, U, R, D, V, alpha, beta, gamma, sigma2, p, mesh):
    """The torch backend's panel-fused step over ``mesh``: the full new
    direction from the (global) pre-update state, this rank's band through
    :func:`_torch_band_fused_step`, the four updated bands all-gathered and
    the (…, 4, t) partials folded in shard order (the reference's
    ``_sharded_xla_panel_fused_step``)."""
    axes = tuple(op.data_axes)
    start, stop = row_band(op.shape[0], mesh, axes)
    bands = [x[..., start:stop, :] for x in (U, R, D, V)]
    *state, red = _torch_band_fused_step(
        op.kernel, op.X[start:stop], op.X, *bands, _new_direction(R, D, V, alpha, beta, gamma),
        alpha, beta, gamma, sigma2, p, compute_dtype=op.compute_dtype,
    )
    red = ordered_psum(torch.stack(red, dim=-2), mesh, axes)
    Un, Rn, Dn, Vn = all_gather_rows(torch.stack(state), mesh, axes).unbind(0)
    return Un, Rn, Dn, Vn, tuple(red[..., k, :] for k in range(4))


def _batch_size(M: torch.Tensor) -> int:
    """The product of M's leading dims before (n, t): 1 for a 2-D M."""
    b = 1
    for s in M.shape[:-2]:
        b *= s
    return b


# --- fault injection (robustness harness) ----------------------------------


class FaultSchedule:
    """Seeded, deterministic host-side fault plan for
    :class:`FaultInjectingOperator` (the reference's, the same decisions).

    One schedule is shared by every prepared / dtype-switched copy of its
    operator, so the call counter ticks once per ACTUAL matmul or fused
    step — once per kernel launch of the CG loop, as the reference's
    ``pure_callback`` ticks once per execution of its scan body — and a
    seed gives the reference's fault sequence.

    Attributes are plain and mutable on purpose: a chaos driver toggles
    ``nan_rate`` / ``total_outage`` mid-run.

      * ``nan_calls`` / ``inf_calls`` — exact call indices to corrupt;
      * ``nan_rate`` — per-call corruption probability from the seeded rng
        (deterministic given the seed and the call order);
      * ``latency_s`` — host sleep per call (operational latency);
      * ``total_outage`` — corrupt EVERY call, and ``to_dense`` too (takes
        out the terminal dense ladder rung: the unhealable fault that must
        trip the serving circuit breaker);
      * ``reduced_only`` — corrupt only reduced-precision (bf16) instances,
        leaving f32 clean — makes the ``precision_f32`` rung heal;
      * ``panel`` — (row_start, num_rows): corrupt this row band instead of
        row 0, one panel of a ``mode="cuda_partitioned"`` solve.

    ``injected`` records ``(call_index, code)`` for every corruption
    delivered — the assertion surface for tests.
    """

    NAN = 1.0
    INF = 2.0

    def __init__(
        self,
        seed: int = 0,
        *,
        nan_calls: Sequence[int] = (),
        inf_calls: Sequence[int] = (),
        nan_rate: float = 0.0,
        latency_s: float = 0.0,
        total_outage: bool = False,
        reduced_only: bool = False,
        panel: tuple | None = None,
    ):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.nan_calls = frozenset(nan_calls)
        self.inf_calls = frozenset(inf_calls)
        self.nan_rate = float(nan_rate)
        self.latency_s = float(latency_s)
        self.total_outage = bool(total_outage)
        self.reduced_only = bool(reduced_only)
        self.panel = None if panel is None else (int(panel[0]), int(panel[1]))
        self.calls = 0
        self.injected: list = []

    def next_code(self, reduced: bool) -> float:
        """Tick the call counter and decide this call's fate (host side)."""
        with self._lock:
            idx = self.calls
            self.calls += 1
            if self.latency_s:
                time.sleep(self.latency_s)
            code = 0.0
            if self.total_outage:
                code = self.NAN
            elif self.reduced_only and not reduced:
                code = 0.0
            elif idx in self.nan_calls:
                code = self.NAN
            elif idx in self.inf_calls:
                code = self.INF
            elif self.nan_rate and self._rng.random() < self.nan_rate:
                code = self.NAN
            if code:
                self.injected.append((idx, code))
            return code

    def rows(self) -> slice:
        """The row band a fault corrupts: the panel band, else row 0."""
        s0, rows = self.panel if self.panel is not None else (0, 1)
        return slice(s0, s0 + rows)


def _corrupt(out: torch.Tensor, code: float, rows: slice) -> torch.Tensor:
    """``out`` with NaN (code NAN) or +Inf (code INF) added to a row band
    of its (…, n, t) rows — or of a vector's entries; ``out`` itself when
    the code is 0."""
    if not code:
        return out
    bad = float("nan") if code == FaultSchedule.NAN else float("inf")
    out = out.clone()
    if out.dim() == 1:
        out[rows] += bad
    else:
        out[..., rows, :] += bad
    return out


@dataclasses.dataclass(frozen=True)
class FaultInjectingOperator(LinearOperator):
    """Wrap any operator with seeded, deterministic fault injection (the
    reference's robustness harness).

    Three fault families:

      * **non-finite outputs** — the schedule corrupts row 0 (or its panel
        band) of the matmul result with NaN/Inf on chosen (or seeded-random)
        calls.  The wrapped operator still launches its kernel; the
        schedule decides on the host, once per call, and the corruption is
        added to the kernel's own output;
      * **non-PSD perturbation** — ``negative_diag`` subtracts c·I;
      * **latency / outage** — host sleeps and the total-outage mode that
        corrupts everything including ``to_dense``.

    ``diagonal`` / ``row`` delegate CLEAN (the pivoted-Cholesky
    preconditioner is not the thing under test).  The wrapper forwards the
    base's fused CG step with the same seam: a corrupted call poisons the
    scheduled row band of the iteration's V′ AND the (4, t) reductions, as
    a faulted launch would (``negative_diag`` stays unfused-only).

    Wrap INSIDE the noise wrapper — ``AddedDiagOperator(FaultInjecting…(K),
    σ²)`` — so ``build_preconditioner`` still sees the ``AddedDiagOperator``
    it requires.
    """

    base: LinearOperator
    schedule: FaultSchedule | None = dataclasses.field(default_factory=FaultSchedule)
    negative_diag: float = 0.0
    reduced: bool = False

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
        out = self.base.matmul(M)
        if self.negative_diag:
            out = out - self.negative_diag * M
        if self.schedule is None:
            return out
        return _corrupt(out, self.schedule.next_code(self.reduced), self.schedule.rows())

    def diagonal(self):
        d = self.base.diagonal()
        return d - self.negative_diag if self.negative_diag else d

    def row(self, i):
        r = self.base.row(i)
        if self.negative_diag:
            r = r.clone()
            r[i] -= self.negative_diag
        return r

    def to_dense(self):
        dense = self.base.to_dense()
        if self.negative_diag:
            n = dense.shape[-1]
            dense = dense - self.negative_diag * torch.eye(n, dtype=dense.dtype,
                                                           device=dense.device)
        if self.schedule is not None and self.schedule.total_outage:
            # the outage takes the dense fallback down too: the unhealable
            # fault class (→ the serving circuit breaker)
            dense = torch.full_like(dense, float("nan"))
        return dense

    def fused_cg_step_fn(self, sigma2=None):
        if self.negative_diag:
            # a structural perturbation of K̂ itself: the unfused loop, whose
            # matmul seam applies it
            return None
        base_fn = self.base.fused_cg_step_fn(sigma2=sigma2)
        sched = self.schedule
        if base_fn is None or sched is None:
            return base_fn
        reduced = self.reduced

        def step(U, R, D, V, alpha, beta, gamma):
            Un, Rn, Dn, Vn, red = base_fn(U, R, D, V, alpha, beta, gamma)
            code = sched.next_code(reduced)
            if code:
                # the faulted rows' V′ goes bad, and so do the epilogue
                # partials already summed into the (4, t) reductions
                Vn = _corrupt(Vn, code, sched.rows())
                bad = float("nan") if code == FaultSchedule.NAN else float("inf")
                red = tuple(r + bad for r in red)
            return Un, Rn, Dn, Vn, red

        return step

    def prepare(self):
        return dataclasses.replace(self, base=self.base.prepare())

    def with_compute_dtype(self, compute_dtype):
        return dataclasses.replace(
            self,
            base=self.base.with_compute_dtype(compute_dtype),
            reduced=self.reduced or is_reduced(compute_dtype),
        )

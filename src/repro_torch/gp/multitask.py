"""Multitask GP regression: Kronecker-structured BBMM for multi-output data
(counterpart of ``repro.gp.multitask``).

The covariance over T tasks is

    K = K_X ⊗ K_T + Σ_noise,        K_T = B·Bᵀ + diag(v)  (learned, T × T)

with K_X any data kernel (RBF / Matérn, or a deep kernel through
``kernel_fn``) in any of the port's modes (``dense`` / ``blocked`` /
``cuda``, or ``cuda_sharded`` with the data kernel's rows sharded over the
ambient mesh) and Σ_noise per task.  One Kronecker product costs
O(t·(n²T + nT²)): the O(n²) data-kernel work is ONE call of the data
operator with T·t stacked columns — under ``mode="cuda"`` one launch of
the kernel-matrix kernel (B1, or its bf16 mode under "mixed") per CG
iteration, and one gradient-kernel launch per backward.

Data are in the **long format**: every observation is one row
``(x₁ … x_d, task_id)`` of an (m, d+1) array with a scalar target, which
``fit_gp`` and :class:`repro_torch.serving.PosteriorSession` (streaming
``observe`` of new (x, task, y) rows included) take unchanged.
``prepare_inputs`` classifies the panel:

  * a **complete grid** (every location observed for all T tasks,
    data-major) → :class:`repro_torch.core.KroneckerKernelOperator` over the
    n distinct locations;
  * a **heterogeneous panel** →
    :class:`repro_torch.core.HadamardKroneckerOperator`, the task-id gather
    with the same one-data-matmul structure.

The two agree entry for entry where both apply.  ``fuse_cg=True`` warns and
falls back to the unfused loop (the Kronecker operators have no fused
step), and task-kernel preconditioning is not implemented: multitask
solves run at ``precond_rank=0``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import (
    BBMMSettings,
    HadamardKroneckerOperator,
    KroneckerAddedDiagOperator,
    KroneckerKernelOperator,
    cached_inv_quad,
    marginal_log_likelihood,
)
from repro_torch.core import solve as bbmm_solve
from repro_torch.device import resolve_device

from .exact import KERNELS, _inv_softplus, _softplus
from .kernels import KernelOperator
from .model import KrylovCachePredictor
from .training import fit_gp

MODES = ("dense", "blocked", "cuda", "cuda_sharded")


class MultitaskData(NamedTuple):
    """``prepare_inputs`` output: the hyperparameter-free panel geometry.

    ``task_ids=None`` marks a complete data-major grid (Kronecker structure;
    ``X`` holds the n distinct locations); otherwise ``X`` holds per-row
    coordinates and ``task_ids`` the per-row task (Hadamard structure)."""

    X: torch.Tensor  # (n, d) distinct locations | (m, d) per-row coordinates
    task_ids: torch.Tensor | None  # None (grid) | (m,) int64
    num_tasks: int


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_long_format(X, Y=None, *, task_ids=None, num_tasks=None):
    """Encode multitask observations as long-format rows (float32 numpy).

    * complete grid — ``to_long_format(X, Y)`` with X (n, d) and Y (n, T):
      every location crossed with tasks 0..T-1 (data-major); returns
      ``(X_long (n·T, d+1), y_long (n·T,))``;
    * heterogeneous panel — ``to_long_format(X, task_ids=ids, num_tasks=T)``
      with X (m, d) and per-row task ids; returns ``X_long (m, d+1)``."""
    X = np.atleast_2d(_numpy(X)).astype(np.float32)
    if task_ids is not None:
        ids = _numpy(task_ids)
        if num_tasks is not None and ids.size and (ids.min() < 0 or ids.max() >= num_tasks):
            raise ValueError(
                f"task ids must lie in [0, {num_tasks}); got range [{ids.min()}, {ids.max()}]"
            )
        return np.concatenate([X, ids.astype(np.float32)[:, None]], axis=-1)
    Y = _numpy(Y).astype(np.float32)
    n, T = Y.shape
    coords = np.repeat(X, T, axis=0)  # (n·T, d), data-major
    tasks = np.tile(np.arange(T, dtype=np.float32), n)[:, None]
    return np.concatenate([coords, tasks], axis=-1), Y.reshape(-1)


def split_long_format(X_long: torch.Tensor):
    """(coords, task_ids) from long-format rows — the inverse of
    :func:`to_long_format` (task ids are stored as floats and read back by
    rounding)."""
    X_long = torch.atleast_2d(X_long)
    return X_long[:, :-1], torch.round(X_long[:, -1]).to(torch.int64)


def _detect_grid(coords: np.ndarray, tasks: np.ndarray, T: int) -> bool:
    """True iff the panel is a complete data-major grid: m = n·T rows,
    tasks cycling 0..T-1, the T rows of each block sharing one location."""
    m = coords.shape[0]
    if m == 0 or m % T != 0:
        return False
    if not np.array_equal(tasks, np.tile(np.arange(T), m // T)):
        return False
    blocks = coords.reshape(m // T, T, -1)
    return bool(np.all(blocks == blocks[:, :1]))


@dataclasses.dataclass
class MultitaskGP(KrylovCachePredictor):
    """Multitask GP with covariance K_X ⊗ K_T + Σ_noise (GPModel protocol)
    on long-format inputs (m, d+1) whose last column is the task id.

    Parameters: the data kernel's lengthscale / outputscale (shared across
    tasks), the task kernel K_T = B·Bᵀ + diag(softplus(v)) with B
    (num_tasks, task_rank), and per-task noises σ²_τ.  At init K_T ≈ I with
    a small random B, so correlation gradients are nonzero.

    ``structure``: ``"auto"`` takes the Kronecker operator on a complete
    grid and the Hadamard gather otherwise; ``"kronecker"`` requires the
    grid; ``"hadamard"`` forces the gather.  ``kernel_fn(params) -> kernel``
    overrides the data kernel (a :class:`repro_torch.gp.kernels.DeepKernel`
    over ``params["net"]``, with ``extra_params_init(generator)`` adding
    the network to ``init_params``); deep kernels run in dense or blocked
    mode.  ``mode="cuda"`` is the reference's ``"pallas"``,
    ``"cuda_sharded"`` its ``"pallas_sharded"`` (the data kernel row-sharded
    over the ambient :func:`repro_torch.distributed.use_mesh` mesh; none
    raises ``ValueError``)."""

    num_tasks: int = 2
    task_rank: int = 1
    kernel_type: str = "rbf"
    mode: str = "dense"  # dense | blocked | cuda | cuda_sharded
    block_size: int = 512
    structure: str = "auto"  # auto | kronecker | hadamard
    settings: BBMMSettings = dataclasses.field(
        default_factory=lambda: BBMMSettings(precond_rank=0)
    )
    precision: str | None = None  # None follows settings; explicit wins
    fuse_cg: bool | None = None  # None follows settings; True warns + falls back
    kernel_fn: Callable | None = None  # params -> data kernel (deep kernels)
    extra_params_init: Callable | None = None  # generator -> extra param leaves
    # None → CUDA (raises without a GPU); "cpu" runs the plain path
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.precision is not None:
            self.settings = dataclasses.replace(self.settings, precision=self.precision)
        if self.fuse_cg is not None:
            self.settings = dataclasses.replace(self.settings, fuse_cg=self.fuse_cg)
        if self.settings.precond_rank > 0:
            raise ValueError(
                "task-kernel preconditioning for Kronecker multitask operators is "
                "not implemented — construct MultitaskGP with settings.precond_rank=0 "
                f"(got {self.settings.precond_rank})"
            )
        if self.structure not in ("auto", "kronecker", "hadamard"):
            raise ValueError(f"unknown structure {self.structure!r}")
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- GPModel protocol: inputs / parameterization -------------------------
    def _check_tasks(self, tasks: np.ndarray, what: str = "task ids") -> None:
        if tasks.size and (tasks.min() < 0 or tasks.max() >= self.num_tasks):
            raise ValueError(
                f"{what} must lie in [0, {self.num_tasks}); got range "
                f"[{tasks.min()}, {tasks.max()}]"
            )

    def prepare_inputs(self, X) -> MultitaskData:
        """Classify the long-format panel (complete grid or heterogeneous) and
        strip it to hyperparameter-free geometry.  On the host once per fit
        or serving state (one device-to-host copy), never inside a solve."""
        coords, task_ids = split_long_format(self._tensor(X))
        tasks_np = task_ids.cpu().numpy()
        self._check_tasks(tasks_np)
        grid = self.structure != "hadamard" and _detect_grid(
            coords.cpu().numpy(), tasks_np, self.num_tasks
        )
        if self.structure == "kronecker" and not grid:
            raise ValueError(
                "structure='kronecker' requires a complete data-major grid (every "
                "location observed for tasks 0..T-1, in order); use structure='auto' "
                "or 'hadamard' for heterogeneous panels"
            )
        if grid:
            return MultitaskData(X=coords[:: self.num_tasks].contiguous(), task_ids=None,
                                 num_tasks=self.num_tasks)
        return MultitaskData(X=coords.contiguous(), task_ids=task_ids, num_tasks=self.num_tasks)

    def init_params(self, X, ard: bool = False, generator: torch.Generator | None = None):
        """Initial parameters; ``generator`` (default: a CPU generator seeded
        with 0) draws the task root B and any ``extra_params_init``."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        d = X if isinstance(X, int) else X.shape[-1] - 1  # last column = task id
        T = self.num_tasks
        full = lambda shape, v: torch.full(shape, _inv_softplus(v), dtype=torch.float32,  # noqa: E731
                                           device=self.device)
        root = 0.1 * torch.randn((T, self.task_rank), generator=generator,
                                 device=generator.device)
        params = {
            "raw_lengthscale": full((d,) if ard else (), 0.5),
            "raw_outputscale": full((), 1.0),
            # small random B: K_T ≈ I at init but with a nonzero ∂(BBᵀ)/∂B
            # (B = 0 is a stationary point of the low-rank term)
            "raw_task_root": root.to(self.device),
            "raw_task_diag": full((T,), 1.0),
            "raw_noise": full((T,), 0.1),
        }
        if self.extra_params_init is not None:
            params.update(self.extra_params_init(generator))
        return params

    def kernel(self, params):
        """The data kernel K_X (shared across tasks)."""
        if self.kernel_fn is not None:
            return self.kernel_fn(params)
        return KERNELS[self.kernel_type](
            lengthscale=_softplus(params["raw_lengthscale"]),
            outputscale=_softplus(params["raw_outputscale"]),
        )

    def task_covariance(self, params):
        """K_T = B·Bᵀ + diag(softplus(v)) — low-rank plus diagonal, (T, T)."""
        B = params["raw_task_root"]
        return B @ B.T + torch.diag(_softplus(params["raw_task_diag"]))

    def noise(self, params):
        """Per-task noise σ²_τ, (T,)."""
        return _softplus(params["raw_noise"])

    def operator(self, params, data: MultitaskData) -> KroneckerAddedDiagOperator:
        """The blackbox K̂ = K_X ⊗ K_T + Σ_noise the engine solves against."""
        data_op = KernelOperator(kernel=self.kernel(params), X=data.X, mode=self.mode,
                                 block_size=self.block_size)
        KT = self.task_covariance(params)
        if data.task_ids is None:
            base = KroneckerKernelOperator(data_op, KT)
        else:
            base = HadamardKroneckerOperator(data_op, KT, data.task_ids)
        return KroneckerAddedDiagOperator(base, self.noise(params), data.task_ids)

    # -- training -------------------------------------------------------------
    def loss(self, params, data, y, generator):
        """−MLL of the flat (m,) targets through the multitask operator."""
        return -marginal_log_likelihood(
            self.operator(params, data), self._tensor(y), generator, self.settings
        )

    def fit(self, X, y, *, steps=100, lr=0.1, generator=None, callback=None):
        return fit_gp(self, X, y, steps=steps, lr=lr, generator=generator, callback=callback)

    # posterior_cache / update_cache: KrylovCachePredictor's — the multitask
    # cache IS the exact-GP Krylov cache over the (m, m) system, and observe
    # streams new (x, task, y) rows through extend_posterior_cache unchanged.

    # -- prediction -----------------------------------------------------------
    def _query_parts(self, Xstar):
        """Split and validate long-format query rows (one host check: a
        wrong id would otherwise index another task's row or fail on the
        device)."""
        coords, qt = split_long_format(self._tensor(Xstar))
        if qt.numel():
            lo, hi = (int(v) for v in torch.aminmax(qt))
            if lo < 0 or hi >= self.num_tasks:
                raise ValueError(
                    f"query task ids must lie in [0, {self.num_tasks}); got range [{lo}, {hi}]"
                )
        return coords, qt

    def _cross_cov(self, data: MultitaskData, KT, Kx, qt):
        """k((X_train, τ_train), (X*, τ*)), (m_train, s), from the shared data
        cross block Kx = K_X(X_train, X*): K_X(xᵢ, x*_q)·K_T[τᵢ, τ*_q]."""
        if data.task_ids is None:
            task_part = KT[:, qt]  # (T, s)
            s = Kx.shape[1]
            return (Kx[:, None, :] * task_part[None, :, :]).reshape(-1, s)
        return Kx * KT[data.task_ids][:, qt]

    def _cross(self, params, data: MultitaskData, coords):
        """K_X(X_train, X*) under the model's precision policy."""
        return super()._cross(params, data.X, coords)

    def _cached_mean(self, data: MultitaskData, cross, KT, Kx, alpha, qt):
        """k*ᵀα through ONE test-vs-train contraction: the task weighting is
        folded into α first (W[i, τ] = Σ over point i's rows of
        K_T[τ_row, τ]·α_row), so the O(s·n·T) work is one
        ``cross.contract`` over the shared Kx block."""
        if data.task_ids is None:
            W = alpha.reshape(-1, data.num_tasks) @ KT  # (n, T)
        else:
            W = alpha[:, None] * KT[data.task_ids]  # (m, T)
        out = cross.contract(Kx.T, W)  # (s, T)
        return torch.take_along_dim(out, qt[:, None], dim=1)[:, 0]

    def predict_cached(self, params, data, cache, Xstar, *, full_cov=False):
        """Mean + variance from the Krylov cache — zero CG iterations.  The
        variance is the conservative Rayleigh–Ritz bound plus the query
        row's task noise; K_X(X_train, X*) is evaluated once."""
        coords, qt = self._query_parts(Xstar)
        kern = self.kernel(params)
        KT = self.task_covariance(params)
        cross = self._cross(params, data, coords)
        Kx = cross.to_dense()  # the one kernel evaluation per query
        mean = self._cached_mean(data, cross, KT, Kx, cache.alpha, qt)
        Kxs = self._cross_cov(data, KT, Kx, qt)
        if full_cov:
            if cache.basis is None:
                raise ValueError(
                    "cache was built with variance_cache=False; rebuild with "
                    "variance_cache=True for covariance queries"
                )
            v = cache.basis.T @ Kxs
            w = torch.cholesky_solve(v, cache.gram_chol)
            return mean, kern(coords, coords) * KT[qt][:, qt] - v.T @ w
        var = kern.diag(coords) * torch.diagonal(KT)[qt] - cached_inv_quad(cache, Kxs)
        return mean, torch.clamp(var, min=1e-8) + self.noise(params)[qt]

    def predict(self, params, data, y, Xstar, *, full_cov=False, generator=None):
        """Posterior mean and per-task predictive variance at long-format
        query rows — exact mBCG solves for the variance, the cached-mean
        program of ``predict_cached`` for the mean."""
        coords, qt = self._query_parts(Xstar)
        cache = self.posterior_cache(params, data, y, generator=generator, variance_cache=False)
        op = self.operator(params, data)
        kern = self.kernel(params)
        KT = self.task_covariance(params)
        cross = self._cross(params, data, coords)
        Kx = cross.to_dense()
        mean = self._cached_mean(data, cross, KT, Kx, cache.alpha, qt)
        Kxs = self._cross_cov(data, KT, Kx, qt)
        solves = bbmm_solve(op, Kxs, self.settings, precond=cache.precond)
        if full_cov:
            return mean, kern(coords, coords) * KT[qt][:, qt] - Kxs.T @ solves
        var = kern.diag(coords) * torch.diagonal(KT)[qt] - torch.sum(Kxs * solves, dim=0)
        return mean, torch.clamp(var, min=1e-8) + self.noise(params)[qt]

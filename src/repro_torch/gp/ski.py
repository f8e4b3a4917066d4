"""SKI / KISS-GP through BBMM (paper §5; counterpart of ``repro.gp.ski``).

K̂ ≈ W·K_UU·Wᵀ + σ²I with
  * W — sparse cubic-convolution interpolation weights (4 taps per
    dimension, Keys 1981), computed once from the data and the grid;
  * K_UU — the kernel on a regular grid: a (Kronecker product of)
    symmetric Toeplitz matrices, multiplied through the FFT circulant
    embedding in O(m log m) per column.

The blackbox matmul costs O(t·n·4^d + t·m log m) — the paper's SKI
complexity — as plain ``torch.fft`` and indexing: no kernel launch.
Multi-dimensional grids use the separable (product) RBF kernel, the
outputscale on the first factor.

The hyperparameter-free geometry (the grid, W, and Wᵀ's fixed summation
order) is SKI's ``data`` in the GPModel protocol: ``prepare_inputs(X)``
builds it and every other method takes it where the other models take X.
Serving is rebuild-only, as in the reference: SKI has no ``update_cache``,
so a :class:`repro_torch.serving.PosteriorSession` re-runs
``prepare_inputs`` on the grown X and rebuilds on every ``observe``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import (
    AddedDiagOperator,
    BBMMSettings,
    InterpolatedOperator,
    KroneckerOperator,
    ToeplitzOperator,
    build_posterior_cache,
    cached_inv_quad,
    cached_mean,
    interpolation_order,
    marginal_log_likelihood,
)
from repro_torch.core import solve as bbmm_solve
from repro_torch.device import resolve_device

from .exact import _inv_softplus, _softplus
from .model import KrylovCachePredictor
from .training import fit_gp


def _cubic_weights(u):
    """Keys cubic-convolution weights for the fraction u ∈ [0, 1) at taps
    (−1, 0, 1, 2) relative to the left grid point (a = −0.5)."""
    a = -0.5
    s0 = u + 1.0  # distance to tap −1, in (1, 2)
    s1 = u  # tap 0, in [0, 1)
    s2 = 1.0 - u  # tap 1
    s3 = 2.0 - u  # tap 2, in (1, 2]

    def inner(s):
        return ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0

    def outer(s):
        return ((a * s - 5.0 * a) * s + 8.0 * a) * s - 4.0 * a

    return torch.stack([outer(s0), inner(s1), inner(s2), outer(s3)], dim=-1)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Regular per-dimension grid and its interpolation structure."""

    mins: torch.Tensor  # (d,)
    steps: torch.Tensor  # (d,)
    sizes: tuple  # per-dimension sizes

    @staticmethod
    def fit(X, sizes):
        pad = 3  # room for the cubic stencil at the borders
        mins = X.min(0).values
        maxs = X.max(0).values
        inner = torch.tensor([s - 1 - 2 * pad for s in sizes], dtype=X.dtype, device=X.device)
        steps = (maxs - mins) / inner
        return Grid(mins - pad * steps, steps, tuple(sizes))

    @property
    def num_points(self) -> int:
        m = 1
        for s in self.sizes:
            m *= s
        return m

    def points(self, dim):
        arange = torch.arange(self.sizes[dim], dtype=self.steps.dtype, device=self.steps.device)
        return self.mins[dim] + self.steps[dim] * arange

    def interpolate(self, X):
        """Sparse W: (indices int64, values), each (n, 4^d); row i's taps are
        distinct (the left tap is clipped to [1, size − 3])."""
        n, d = X.shape
        taps = torch.arange(-1, 3, device=X.device)
        idx_list, w_list = [], []
        for dim in range(d):
            pos = (X[:, dim] - self.mins[dim]) / self.steps[dim]
            left = torch.clamp(torch.floor(pos).to(torch.int64), 1, self.sizes[dim] - 3)
            idx_list.append(left[:, None] + taps[None, :])
            w_list.append(_cubic_weights(pos - left.to(pos.dtype)))

        # tensor-product combination across dimensions → flat (row-major)
        # grid indices
        indices, values = idx_list[0], w_list[0]
        for dim in range(1, d):
            indices = (indices[:, :, None] * self.sizes[dim] + idx_list[dim][:, None, :]).reshape(n, -1)
            values = (values[:, :, None] * w_list[dim][:, None, :]).reshape(n, -1)
        return indices, values


@dataclasses.dataclass
class SKI:
    grid_size: int = 100  # per dimension
    kernel_type: str = "rbf"
    settings: BBMMSettings = dataclasses.field(default_factory=BBMMSettings)
    # "highest" | "mixed": SKI's heavy stage is the FFT Toeplitz product,
    # whose circulant embedding is unsafe at bf16, so the operator stays
    # f32 (ToeplitzOperator.with_compute_dtype is a no-op) and "mixed"
    # engages only mBCG's residual refresh.  None follows settings.precision
    precision: str | None = None
    # API uniformity: the interpolated Toeplitz operator has no fused step,
    # so True runs the unfused loop.  None follows settings.fuse_cg
    fuse_cg: bool | None = None
    # None → CUDA (raises without a GPU); "cpu" runs on the host
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.kernel_type != "rbf":
            raise ValueError("SKI's grid kernel is the separable RBF: kernel_type must be 'rbf'")
        if self.precision is not None:
            self.settings = dataclasses.replace(self.settings, precision=self.precision)
        if self.fuse_cg is not None:
            self.settings = dataclasses.replace(self.settings, fuse_cg=self.fuse_cg)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # seeded with 0 by default: rebuilds are deterministic, and predict's
    # mean runs predict_cached's mBCG program
    _generator = KrylovCachePredictor._generator

    # -- GPModel protocol: inputs / parameterization --------------------------
    def init_params(self, X):
        d = X if isinstance(X, int) else X.shape[1]
        full = lambda shape, v: torch.full(shape, _inv_softplus(v), dtype=torch.float32,  # noqa: E731
                                           device=self.device)
        return {
            "raw_lengthscale": full((d,), 0.5),
            "raw_outputscale": full((), 1.0),
            "raw_noise": full((), 0.1),
        }

    def prepare_inputs(self, X):
        """The hyperparameter-free geometry: the grid, W as (indices,
        values) and Wᵀ's summation order (``order``, ``offsets``)."""
        X = self._tensor(X)
        grid = Grid.fit(X, (self.grid_size,) * X.shape[1])
        indices, values = grid.interpolate(X)
        order, offsets = interpolation_order(indices, grid.num_points)
        return {"grid": grid, "indices": indices, "values": values, "order": order,
                "offsets": offsets}

    # the reference's historical name
    prepare = prepare_inputs

    def _kuu(self, params, grid: Grid):
        """Kronecker-of-Toeplitz K_UU (separable RBF across dimensions)."""
        ell = _softplus(params["raw_lengthscale"])
        out = _softplus(params["raw_outputscale"])
        factors = []
        for dim in range(len(grid.sizes)):
            pts = grid.points(dim).to(ell.dtype)  # f64 parameters give an f64 column
            col = torch.exp(-0.5 * ((pts - pts[0]) / ell[dim]) ** 2)
            if dim == 0:
                col = col * out
            factors.append(ToeplitzOperator(col))
        return factors[0] if len(factors) == 1 else KroneckerOperator(tuple(factors))

    def _interpolated(self, geom, kuu) -> InterpolatedOperator:
        return InterpolatedOperator(indices=geom["indices"], values=geom["values"], base=kuu,
                                    order=geom["order"], offsets=geom["offsets"])

    def operator(self, params, geom) -> AddedDiagOperator:
        return AddedDiagOperator(self._interpolated(geom, self._kuu(params, geom["grid"])),
                                 self.noise(params))

    def noise(self, params):
        return _softplus(params["raw_noise"])

    # -- training -------------------------------------------------------------
    def loss(self, params, geom, y, generator):
        """−MLL, differentiable in ``params`` (through the Toeplitz columns
        and σ²); ``generator`` draws the probes."""
        return -marginal_log_likelihood(self.operator(params, geom), self._tensor(y), generator,
                                        self.settings)

    def fit(self, X, y, *, steps=100, lr=0.1, generator=None, callback=None):
        """(params, history) through the shared driver; the geometry it used
        is ``self.prepare_inputs(X)`` again (deterministic in X)."""
        return fit_gp(self, X, y, steps=steps, lr=lr, generator=generator, callback=callback)

    # -- serving ----------------------------------------------------------------
    def _cross(self, params, geom, Xstar):
        """(K_X* (n, s), k** (s,)): k(x*, X) ≈ w*ᵀ·K_UU·Wᵀ on the training
        grid.  W*ᵀ is written straight into an (m, s) zero matrix — a query
        point's taps are distinct, so this is exact and sums nothing — and
        K_X* is formed once per request."""
        grid = geom["grid"]
        kuu = self._kuu(params, grid)
        Xstar = self._tensor(Xstar)
        s_idx, s_val = grid.interpolate(Xstar)
        s = Xstar.shape[0]
        Wst = torch.zeros((grid.num_points, s), dtype=s_val.dtype, device=s_val.device)
        Wst[s_idx, torch.arange(s, device=s_idx.device)[:, None]] = s_val
        KXs = self._interpolated(geom, kuu)._W_matmul(kuu.matmul(Wst))
        return KXs, InterpolatedOperator(indices=s_idx, values=s_val, base=kuu).diagonal()

    def posterior_cache(self, params, geom, y, *, generator=None, variance_cache=True):
        """One engine call → a :class:`repro_torch.core.PosteriorCache` over
        the SKI operator (the default generator makes rebuilds
        deterministic, and ``predict`` shares this path for its mean)."""
        return build_posterior_cache(self.operator(params, geom), self._tensor(y),
                                     self._generator(generator), self.settings,
                                     variance_cache=variance_cache)

    def predict_cached(self, params, geom, cache, Xstar):
        """Mean and variance from the cache — zero CG iterations:
        O(s·4^d + m log m) interpolation plus the O(n·m) Rayleigh–Ritz
        variance (conservative)."""
        KXs, kss = self._cross(params, geom, Xstar)
        var = kss - cached_inv_quad(cache, KXs)
        return cached_mean(cache, KXs), torch.clamp(var, min=1e-8) + self.noise(params)

    def predict(self, params, geom, y, Xstar, *, generator=None):
        """Mean from the posterior cache (bit for bit ``predict_cached``'s);
        variance from exact mBCG solves against K_X*, reusing the cache's
        preconditioner."""
        cache = self.posterior_cache(params, geom, y, generator=generator, variance_cache=False)
        KXs, kss = self._cross(params, geom, Xstar)
        solves = bbmm_solve(self.operator(params, geom), KXs, self.settings,
                            precond=cache.precond)
        var = kss - torch.sum(KXs * solves, dim=0)
        return cached_mean(cache, KXs), torch.clamp(var, min=1e-8) + self.noise(params)

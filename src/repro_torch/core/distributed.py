"""Distributed BBMM without a kernel: the row-band sharded kernel matmul in
plain torch (counterpart of ``repro.core.distributed``).

Layout, in the port's global view: every rank holds X (n, d) and the full
right-hand side M; it owns rows [i₀, i₁) of K̂ and computes K(X[i₀:i₁], ·)
against column *chunks* of X, so the live kernel tile is (n_loc × chunk),
then the bands are all-gathered.  Collectives per matmul: one all-gather of
the n·t output — O(n) communication against O(n²/S) compute.

It launches no kernel of this package (``mode="cuda_sharded"`` of
:class:`repro_torch.gp.kernels.KernelOperator` is the kernel path); it is
the reference's non-Pallas sharded operator, differentiable by autograd
through each rank's band with the band-sharded backward of
:class:`repro_torch.core.linear_operator._ShardedBandMatmulFn`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import current_mesh, row_band

from .linear_operator import (
    LinearOperator,
    _mixed_matmul,
    _ShardedBandMatmulFn,
    replace_tensor_leaves,
    tensor_leaves,
)
from .mbcg import plain_cg_step
from .precision import is_reduced, normalize_compute_dtype


def _local_block_matmul(kernel, X_local, X_full, M_full, chunk: int, reduced: bool):
    """Σ_c K(X_local, X_full[c]) @ M_full[c] without forming the row panel:
    one (n_loc × chunk) tile per column chunk, each under
    ``torch.utils.checkpoint`` so the backward recomputes tiles instead of
    saving O(n²/S) of them.  bf16 operands (``reduced``) with f32
    accumulation, else f32; the sum is f32."""

    def part(Xb, Mb):
        tile = kernel(X_local, Xb).to(torch.float32)
        return _mixed_matmul(tile, Mb) if reduced else tile @ Mb.to(torch.float32)

    out = None
    for c in range(0, X_full.shape[0], chunk):
        p = checkpoint(part, X_full[c : c + chunk], M_full[..., c : c + chunk, :],
                       use_reentrant=False)
        out = p if out is None else out + p
    return out


@dataclasses.dataclass(frozen=True)
class ShardedKernelOperator(LinearOperator):
    """Row-block sharded exact-GP kernel operator over a mesh (the ``mesh``
    field, else the ambient :func:`repro_torch.distributed.use_mesh`; none
    raises ``ValueError``).  ``data_axes`` names the mesh axes that shard
    the n rows; an n they do not divide raises ``ValueError``."""

    kernel: object
    X: torch.Tensor  # (n, d), the same on every rank
    data_axes: tuple = ("data",)
    chunk: int = 8192
    compute_dtype: str = "float32"  # bf16 operands, f32 accumulation
    mesh: object = None

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

    def _mesh(self):
        mesh = self.mesh if self.mesh is not None else current_mesh()
        if mesh is None:
            raise ValueError("ShardedKernelOperator needs a mesh (the mesh field or use_mesh)")
        return mesh

    def matmul(self, M):
        squeeze = M.dim() == 1
        if squeeze:
            M = M[:, None]
        mesh, axes = self._mesh(), tuple(self.data_axes)
        start, stop = row_band(self.shape[0], mesh, axes)
        kernel, chunk = self.kernel, self.chunk
        reduced = is_reduced(self.compute_dtype)

        def band_fn(m, leaves):
            X, kern = leaves[0], replace_tensor_leaves(kernel, leaves[1:])
            return _local_block_matmul(kern, X[start:stop], X, m, chunk, reduced)

        out = _ShardedBandMatmulFn.apply(band_fn, (start, stop), mesh, axes, M, self.X,
                                         *tensor_leaves(kernel))
        return out[..., 0] if squeeze else out

    def row(self, i):
        return self.kernel(self.X[i][None, :], self.X)[0]

    def diagonal(self):
        return self.kernel.diag(self.X)

    def with_compute_dtype(self, compute_dtype):
        return dataclasses.replace(self, compute_dtype=normalize_compute_dtype(compute_dtype))

    def fused_cg_step_fn(self, sigma2=None):
        """The CG step of K̂ = K + σ²I from the port's plain CG step over
        this operator's sharded matmul (every rank runs the elementwise
        recurrence on the full state; the band matmul is the only sharded
        work).  None without a mesh, for an n the shards do not divide, or
        for a batched σ² (the unfused loop)."""
        s2 = torch.zeros((), device=self.X.device) if sigma2 is None else torch.as_tensor(sigma2)
        mesh = self.mesh if self.mesh is not None else current_mesh()
        if s2.dim() or mesh is None or self.shape[0] % mesh.num_shards(tuple(self.data_axes)):
            return None
        return plain_cg_step(lambda D: self.matmul(D) + s2 * D)

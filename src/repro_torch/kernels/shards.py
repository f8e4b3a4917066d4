"""Kernel wrappers on DTensor operands: a kernel launches on each rank's
shard and its output is wrapped back with the same placements.

A kernel computes independently over some axes of its operands (B4 and
B5: the batch and the heads); so do the plain attention and the SSD
state that the models run on a mesh, which take the same path.  Per mesh dimension every operand must be
replicated, or all of them sharded along one such axis (an operand
without that axis replicated); any other layout — a sequence or head_dim
shard, a pending sum — raises and names it, and the caller redistributes
first.  No layout falls back to the plain version.
"""

from __future__ import annotations

import torch

from ..distributed.sharding import is_dtensor


def _global_stride(local, shape):
    """Contiguous strides for ``shape`` in ``local``'s dimension order (the
    kernels write transposed views: the global tensor keeps that layout)."""
    order = sorted(range(local.dim()), key=lambda i: (local.stride(i), -i))
    stride, acc = [0] * local.dim(), 1
    for i in order:
        stride[i] = acc
        acc *= shape[i]
    return tuple(stride)


class _GradLike(torch.autograd.Function):
    """The identity, whose backward lays the gradient out in the strides of
    its input: DTensor wraps a local gradient as the layout of the global
    tensor it claims, and a view on it fails when the local gradient came
    out transposed (the plain attention's backward)."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.shape, x.stride())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, stride = ctx.layout
        if g.stride() == stride:
            return g
        return torch.empty_strided(shape, stride, dtype=g.dtype, device=g.device).copy_(g)


def launch_on_shards(fn, name, operands, axes, out_of, *, whole=None, shape=None, **kw):
    """``fn(*local operands, **kw)`` on this rank's shards, the result a
    DTensor laid out as operand ``out_of`` and of its global shape, or of
    ``shape`` (an output whose sharded dimensions are ``out_of``'s).

    ``axes``: per operand, {logical axis: tensor dimension} of the axes the
    kernel is independent over; ``whole``: {logical axis: [(operand,
    dimension), ...]} whose sizes every shard must divide evenly (B4's q
    and kv heads, so that a rank's q heads read its own kv heads).  The
    local views are differentiable: a caller on the plain paths (the
    models' attention and state on a mesh) trains through them."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not all(is_dtensor(t) for t in operands):
        raise TypeError(f"{name}: mix of DTensor and plain operands; lay every operand "
                        "out on the mesh first")
    dm = operands[0].device_mesh
    if any(t.device_mesh != dm for t in operands):
        raise ValueError(f"{name}: operands lie on different meshes")
    shards = {}
    for md, dim_name in enumerate(dm.mesh_dim_names or range(dm.ndim)):
        pls = [t.placements[md] for t in operands]
        if all(isinstance(p, Replicate) for p in pls):
            continue
        ok = None
        for axis in {a for ax in axes for a in ax}:
            want = [Shard(ax[axis]) if axis in ax else Replicate() for ax in axes]
            if pls == want:
                ok = axis
        if ok is None:
            layout = [tuple(t.placements) for t in operands]
            raise ValueError(
                f"{name}: cannot launch on mesh dimension {dim_name!r} with operand "
                f"placements {layout}; the kernel runs on batch or head shards, or on "
                "replicated operands — redistribute first")
        shards[ok] = shards.get(ok, 1) * dm.size(md)
    for axis, sites in (whole or {}).items():
        n = shards.get(axis, 1)
        for op, dim in sites:
            if operands[op].shape[dim] % n:
                raise ValueError(f"{name}: {axis} of size {operands[op].shape[dim]} does not "
                                 f"divide into {n} shards")
    local = [t.to_local() for t in operands]
    if torch.is_grad_enabled():
        local = [_GradLike.apply(t) if t.requires_grad else t for t in local]
    out = fn(*local, **kw)
    like = operands[out_of]
    shape = torch.Size(shape or like.shape)
    return DTensor.from_local(out, dm, like.placements, shape=shape,
                              stride=_global_stride(out, shape))

"""GPipe pipeline parallelism over a "stage" mesh axis — the counterpart
of ``repro.distributed.pipeline``.

Each rank of the stage axis runs one stage: layer parameters are stacked
on a leading dimension of size S (one slice per stage) and microbatches
stream through the stages in the classic fill–steady–drain schedule of
T = M + S − 1 ticks.  At every tick each stage runs ``stage_fn`` on the
activation it holds and passes the result to stage (i + 1) mod S with
``torch.distributed.batch_isend_irecv`` on the stage group (the
reference's ``ppermute``); stage 0 takes a fresh microbatch while there
are any, and the last stage keeps what it computes once the pipe is full.
As in the reference every stage computes at every tick, the bubbles on
zeros.  On a gloo group a CUDA activation crosses through host memory
(gloo's point-to-point ops take host tensors only).  The reference ends with a ``psum`` over the stage axis in which
only the last stage is non-zero; here the last stage broadcasts its
outputs, so every rank returns the same bits.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..tree import tree_map
from .sharding import is_dtensor


def _stage_slice(leaf, stage, S):
    """This stage's slice of a leaf stacked over S stages: a plain tensor
    of leading dimension S (the global view), or a DTensor sharded over
    the stage axis (its local shard holds the one slice)."""
    if is_dtensor(leaf):
        local = leaf.to_local()
        if local.shape[0] != 1:
            raise ValueError(f"a stage-sharded leaf holds {local.shape[0]} slices per rank; "
                             "its leading dimension must equal the stage count")
        return local[0]
    if leaf.shape[0] != S:
        raise ValueError(f"leaf of leading dimension {leaf.shape[0]} on {S} stages")
    return leaf[stage]


def pipeline_forward(stage_fn, params_stacked, x_microbatches, *, mesh, axis: str = "stage"):
    """Run M microbatches through S pipeline stages.

    stage_fn(stage_params, x) -> x — one stage's computation (shape
    preserving).  params_stacked: a tree whose leaves have leading
    dimension S.  x_microbatches (M, mb, ...): the same on every rank
    (stage 0's copy is the one read).  Returns (M, mb, ...) outputs, the
    same bits on every rank of the stage group."""
    S = mesh.axis_sizes[axis]
    M = x_microbatches.shape[0]
    T = M + S - 1
    stage = mesh.shard_index((axis,))
    group, members = mesh.group((axis,))
    p = tree_map(lambda a: _stage_slice(a, stage, S), params_stacked)

    state = torch.zeros_like(x_microbatches[0])
    outputs = torch.zeros_like(x_microbatches)
    for t in range(T):
        if stage == 0 and t < M:
            state = x_microbatches[t]
        y = stage_fn(p, state)
        if stage == S - 1 and t >= S - 1:
            outputs[t - (S - 1)] = y
        if S > 1:  # shift the activations forward one stage
            state = _shift(y, members[(stage + 1) % S], members[(stage - 1) % S], group)
    if S > 1:
        dist.broadcast(outputs, src=members[S - 1], group=group)
    return outputs


def _shift(y, dst, src, group):
    """Send ``y`` to rank ``dst`` and receive its successor from ``src``.
    Gloo's point-to-point ops take host memory only: a CUDA tensor on a
    gloo group goes through a host copy each way (the same bits)."""
    staged = y.is_cuda and dist.get_backend(group) == "gloo"
    send = (y.cpu() if staged else y).contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(y.device) if staged else recv

"""The multi-device layer on ``torch.distributed``: the GP system's row
bands and collectives, and the LM's sharding rules on DTensor — the
counterpart of ``repro.distributed.sharding``.

Global view, sharded work: every rank of a world calls the same entry
point with the same X, y, parameters and full right-hand side; each
computes its own contiguous row band of a product and the bands are
all-gathered, so every rank holds the same full result, bit for bit.  The
solver above (mBCG, SLQ, the MLL, ``fit_gp``, the posterior cache) then
runs unchanged, and identically, on every rank.

  * :class:`Mesh` / :func:`make_mesh` — a logical mesh over the default
    process group with the reference's axis names (``"data"``,
    ``"model"``; ``"pod"``), each rank's coordinates row-major over its
    shape, and one process group per set of axes that rows are sharded
    over (the ranks that share their other coordinates).
  * :func:`current_mesh` / :func:`use_mesh` — the thread-local ambient
    mesh, the reference's ``with mesh:``.
  * :func:`mesh_axis_sizes`, :func:`mesh_axes`, :func:`batch_axes`,
    ``Mesh.num_shards``, :func:`row_band` — geometry; a band is
    ``[i·n/S, (i+1)·n/S)`` for shard i of S, and an n that S does not
    divide raises ``ValueError``, as the reference does.
  * :func:`all_gather_rows` and :func:`ordered_psum` — the only two
    collectives.  ``ordered_psum`` all-gathers the partials and folds them
    left to right in shard order from zeros: NCCL's all-reduce order is
    unspecified, and a stopping test that differs by one ulp between two
    ranks leaves the world hung in its next collective, so no sharded path
    sums anything that decides control flow or a result with a plain
    ``all_reduce``.
  * :func:`spawn_world` — start a world of processes on this host (tests,
    ``chip_smoke.py``).  Users start worlds with ``torchrun`` and
    :func:`init_from_env`.

The LM half (the reference's ``sharding.py:108-334``): the rules map a
parameter's tree path, a cache leaf's name or an activation's role to a
partition spec :class:`P` over the axes "pod", "data" and "model"
(``params_shardings``, ``cache_shardings``, ``p_batch``,
``shard_activations``, ``shard_cache_kv``, ``shard_q_like_cache``), and
:func:`placements` turns a spec into DTensor placements on
``Mesh.device_mesh()``.  Every rank runs the same program on the same
global shapes; :func:`distribute` lays a tensor out (the reference's
``device_put``) and :func:`constrain` redistributes one (its
``with_sharding_constraint``), the identity on plain tensors or with no
ambient mesh, so the models' hints cost nothing on one device
(:func:`split_head_weight`, :func:`gather_dim` and :func:`reduce_partial`
lay an operand out before the op that could not take its layout).
:func:`params_for_use` gathers FSDP parameters on use, a training
forward's layer stacks a layer at a time.  An
:class:`AbstractMesh` gives the rules a mesh's geometry with no world (the
rules' tests).  DTensors on CUDA over gloo take their collectives through
:func:`sync_collectives`, which the caller enters around the whole step.

Both backends take the payload where it lies: NCCL gathers CUDA tensors
on the device, gloo CPU tensors and — on torch 2.11 on an H100, checked for
``all_gather``, ``all_gather_into_tensor``, ``all_reduce``, ``broadcast``
and ``reduce_scatter_tensor`` — CUDA tensors too, which it moves through
the host itself.  :func:`collective_counts` counts the gathers and bytes.
"""

from __future__ import annotations

import itertools
import os
import queue
import re
import shutil
import tempfile
import threading
import time
import traceback
from contextlib import contextmanager
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..tree import tree_flatten_with_paths, tree_leaves, tree_map, tree_unflatten

#: the data-parallel axis names, in the order they compose
BATCH_AXES = ("pod", "data")


class Mesh:
    """A logical mesh over the default process group: ``shape`` (one size
    per axis, their product the world size) and ``axis_names``.  A rank's
    coordinates are its global rank unravelled row-major over ``shape``.

    Construction is collective: every rank of the world must build the same
    mesh, in the same order, since it creates one process group per proper
    subset of the axes and per value of the other coordinates (the ranks a
    row band is gathered over).  A plain class, not a dataclass, so that
    operators holding a mesh never walk into it for tensors."""

    def __init__(self, shape, axis_names):
        if not dist.is_initialized():
            raise RuntimeError("a Mesh needs an initialised torch.distributed world "
                               "(torch.distributed.init_process_group, or spawn_world)")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axis_names {self.axis_names} "
                             "differ in length")
        self.size = 1
        for s in self.shape:
            self.size *= s
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks; the world has {world}")
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self._groups = {}
        axes = range(len(self.shape))
        for k in range(1, len(self.shape)):
            for subset in itertools.combinations(axes, k):
                others = [a for a in axes if a not in subset]
                for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                    members = sorted(r for r in range(self.size)
                                     if [self.coords(r)[a] for a in others] == list(fixed))
                    group = dist.new_group(members)
                    if self.rank in members:
                        self._groups[subset] = (group, members)
        self._groups[tuple(axes)] = (None, list(range(self.size)))

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def coords(self, rank: int) -> tuple:
        out = []
        for s in reversed(self.shape):
            out.append(rank % s)
            rank //= s
        return tuple(reversed(out))

    def _axis_index(self, axes) -> tuple:
        missing = [a for a in axes if a not in self.axis_names]
        if missing or len(set(axes)) != len(axes) or not axes:
            raise ValueError(f"axes {tuple(axes)} are not distinct axes of the mesh "
                             f"{self.axis_names}")
        return tuple(self.axis_names.index(a) for a in axes)

    def num_shards(self, axes) -> int:
        out = 1
        for i in self._axis_index(axes):
            out *= self.shape[i]
        return out

    def shard_index(self, axes, rank: int | None = None) -> int:
        """The rank's shard along ``axes``: its coordinates on those axes
        taken row-major in the order given."""
        c = self.coords(self.rank if rank is None else rank)
        idx = 0
        for i in self._axis_index(axes):
            idx = idx * self.shape[i] + c[i]
        return idx

    def group(self, axes):
        """(process group, its global ranks ascending) of the ranks that
        share this rank's coordinates off ``axes``; the group is None for
        all the axes (the default group)."""
        return self._groups[tuple(sorted(self._axis_index(axes)))]

    def device_mesh(self, device_type: str | None = None):
        """The ``torch.distributed`` ``DeviceMesh`` over the same ranks in
        the same row-major order, with the same axis names: the mesh that
        DTensors placed by :func:`named_shardings` live on.  Built once per
        device type (collective: every rank calls it); ``device_type``
        defaults to ``"cuda"`` under NCCL and ``"cpu"`` otherwise (a gloo
        world whose tensors live on the card passes ``"cuda"``)."""
        from torch.distributed.device_mesh import DeviceMesh

        if device_type is None:
            device_type = "cuda" if self.backend == "nccl" else "cpu"
        cache = self.__dict__.setdefault("_device_meshes", {})
        if device_type not in cache:
            cache[device_type] = DeviceMesh(
                device_type, torch.arange(self.size).reshape(self.shape),
                mesh_dim_names=self.axis_names)
        return cache[device_type]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.axis_names}, rank={self.rank}, {self.backend})"


class AbstractMesh:
    """A mesh's geometry with no world behind it: ``shape``, ``axis_names``
    and ``axis_sizes`` (the reference's ``jax.sharding.AbstractMesh``).
    Under :func:`use_mesh` it drives the sharding rules, which read only
    the axis sizes, without a process group."""

    def __init__(self, shape, axis_names):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axis_names {self.axis_names} "
                             "differ in length")

    @property
    def axis_sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def __repr__(self):
        return f"AbstractMesh({self.shape}, {self.axis_names})"


def make_mesh(shape, axis_names) -> Mesh:
    """A :class:`Mesh` over the initialised world (collective: every rank
    calls it)."""
    return Mesh(shape, axis_names)


_AMBIENT = threading.local()


def current_mesh() -> Mesh | None:
    """The mesh installed by the innermost :func:`use_mesh` on this
    thread, or None."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


@contextmanager
def use_mesh(mesh: Mesh):
    """Install ``mesh`` as the ambient mesh for the block (the reference's
    ``with mesh:``): operators and functions that take a mesh use it when
    none is given."""
    stack = getattr(_AMBIENT, "stack", None)
    if stack is None:
        stack = _AMBIENT.stack = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return mesh.axis_sizes


def mesh_axes() -> tuple:
    mesh = current_mesh()
    return mesh.axis_names if mesh is not None else ()


def batch_axes() -> tuple:
    """The data-parallel axes present in the ambient mesh."""
    ax = mesh_axes()
    return tuple(a for a in BATCH_AXES if a in ax)


def has_model_axis() -> bool:
    return "model" in mesh_axes()


def axis_size(name: str) -> int:
    """The ambient mesh's size along ``name`` (1 without a mesh or axis)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    return mesh.axis_sizes.get(name, 1)


def row_band(n: int, mesh: Mesh, axes=("data",)) -> tuple[int, int]:
    """This rank's rows ``[start, stop)`` of n rows sharded over ``axes``."""
    shards = mesh.num_shards(axes)
    if n % shards != 0:
        raise ValueError(f"n={n} must divide evenly over {shards} shards")
    n_loc = n // shards
    idx = mesh.shard_index(axes)
    return idx * n_loc, (idx + 1) * n_loc


# --- collectives -----------------------------------------------------------

_stats_lock = threading.Lock()
_stats = {"all_gathers": 0, "gathered_bytes": 0}


def collective_counts() -> dict:
    """All-gathers since the last reset and the bytes they assembled on
    this rank (every shard's payload)."""
    with _stats_lock:
        return dict(_stats)


def reset_collective_counts() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


def all_gather(x: torch.Tensor, mesh: Mesh, axes=("data",)) -> list[torch.Tensor]:
    """Every shard's ``x`` along ``axes`` (equal shapes), in shard order."""
    group, members = mesh.group(axes)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in members]
    dist.all_gather(parts, x, group=group)
    ordered = [None] * len(members)
    for rank, p in zip(members, parts):
        ordered[mesh.shard_index(axes, rank)] = p
    with _stats_lock:
        _stats["all_gathers"] += 1
        _stats["gathered_bytes"] += x.numel() * x.element_size() * len(members)
    return ordered


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axes=("data",), dim: int = -2) -> torch.Tensor:
    """The full array from each shard's band of rows (dimension ``dim``)."""
    return torch.cat(all_gather(x, mesh, axes), dim=dim)


def ordered_psum(x: torch.Tensor, mesh: Mesh, axes=("data",)) -> torch.Tensor:
    """Deterministic cross-shard sum: all-gather the partials, then fold
    them left to right in shard order from a zeros accumulator — the left
    fold one device performs over the same partials in the same order, so
    every rank gets the same bits and a single device scanning the same
    panels gets them too.  O(S·|x|) bytes instead of an all-reduce's
    O(|x|): for the (4, t) reduction slabs and the hyperparameter partials
    it exists for, not for large operands."""
    total = torch.zeros_like(x)
    for part in all_gather(x, mesh, axes):
        total = total + part
    return total


# --- the LM's sharding rules ----------------------------------------------
#
# The reference's logical-to-mesh rules (MaxText style), resolved against
# the ambient mesh: a spec names, per tensor dimension, the mesh axes it is
# sharded over (None: replicated), and an axis the mesh lacks resolves to
# None, so on a one-device mesh every rule collapses to replication.  The
# rules read only the axis sizes: under an AbstractMesh they run with no
# world.  On tensors, a spec becomes DTensor placements (:func:`placements`):
# axis a on dimension i is ``Shard(i)`` on mesh dimension a.


class P(tuple):
    """A partition spec: one entry per tensor dimension, each None, an axis
    name or a tuple of axis names (sharded over their product, the first
    major) — ``jax.sharding.PartitionSpec``'s values, as a tuple.  A
    one-axis tuple is its axis, as the reference's spec normalises it."""

    tree_leaf = True  # a leaf of the port's trees (repro_torch.tree)

    def __new__(cls, *axes):
        return super().__new__(cls, (a[0] if isinstance(a, tuple) and len(a) == 1 else a
                                     for a in axes))

    def __repr__(self):
        return "P(" + ", ".join(repr(a) for a in self) + ")"


def p_batch(*rest) -> P:
    """P(batch axes, *rest) resolved for the ambient mesh."""
    ba = batch_axes()
    return P(ba if ba else None, *rest)


def placements(spec, axis_names, sizes=None) -> tuple:
    """DTensor placements of ``spec`` on a mesh with ``axis_names``: per
    mesh dimension, ``Shard(i)`` where tensor dimension i names the axis,
    else ``Replicate()``.  A tensor dimension over several axes takes them
    in mesh order (DTensor shards major first), the only order the rules
    produce; any other raises.  Given the axis ``sizes``, an axis of size 1
    is ``Replicate()``: one shard is the whole (and DTensor would carry the
    trivial shard into strided layouts it cannot propagate)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in axis_names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [axis_names.index(a) for a in names if a in axis_names]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {names} of dimension {dim} are not in "
                             f"mesh order {axis_names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} names mesh axis {axis_names[i]!r} twice")
            if sizes is None or sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _Constrain(torch.autograd.Function):
    """Redistribute to ``target`` forward, and the gradient to ``target``
    backward (JAX transposes a sharding constraint onto the cotangent)."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        return x if tuple(x.placements) == target else x.redistribute(x.device_mesh, target)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.target:
            g = g.redistribute(g.device_mesh, ctx.target)
        return g, None


def constrain(x, spec, *, grad: bool = False):
    """The reference's ``jax.lax.with_sharding_constraint``: ``x``
    redistributed to ``spec`` on its mesh.  The identity on a plain tensor
    or with no ambient mesh, where the reference's constraint is the
    identity too.  ``grad`` lays the gradient out by ``spec`` as well, as
    JAX does; without it DTensor hands a backward op whatever layout the
    op after it produced (a head-sharded gradient at a view that splits 8
    KV heads over a model axis of 16).  It is asked for only there: DTensor
    cannot lay a strided gradient out on fake tensors (the dry-run)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    target = placements(spec, mesh.axis_names, mesh.shape)
    if grad and torch.is_grad_enabled() and x.requires_grad:
        return _Constrain.apply(x, target)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)


def gather_dim(x, dim: int):
    """``x`` with the shards of tensor dimension ``dim`` gathered, every
    other placement kept (the identity on a plain tensor)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dim %= x.dim()
    target = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    return x if target == list(x.placements) else x.redistribute(x.device_mesh, target)


def reduce_partial(x):
    """``x`` with every pending sum reduced, its shards kept (the identity
    on a plain tensor)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def constrain_tree(tree, spec_tree):
    """:func:`constrain` leaf by leaf (a cache to ``cache_shardings``)."""
    return tree_map(constrain, tree, spec_tree)


def shard_activations(x, *rest, grad: bool = False):
    """Constrain (B, ...) activations: batch over the data axes; each named
    rest axis is kept where the mesh has it and divides its dimension
    (``grad``: the gradient too, :func:`constrain`)."""
    if not batch_axes():
        return x
    live = set(mesh_axes())
    clean = []
    for dim, a in zip(x.shape[1:], rest):
        if a is None or a not in live or dim % axis_size(a) != 0:
            clean.append(None)
        else:
            clean.append(a)
    return constrain(x, p_batch(*clean), grad=grad)


def heads_spec(num_kv_heads: int, head_dim: int) -> P:
    """The layout of a (B, S, heads, hd) query, key, value or KV-cache
    tensor of a model with ``num_kv_heads`` KV heads: batch over data; the
    heads over "model" where the model axis divides the KV heads (a query's
    heads then split along their KV groups), else head_dim where it divides
    that, else replicated — the fallbacks of :func:`shard_cache_kv`."""
    m = axis_size("model")
    if m > 1 and num_kv_heads % m == 0:
        return p_batch(None, "model", None)
    if m > 1 and head_dim % m == 0:
        return p_batch(None, None, "model")
    return p_batch(None, None, None)


def split_heads(t, heads: int, head_dim: int, num_kv_heads: int):
    """(B, S, heads · head_dim) → (B, S, heads, head_dim) in the
    :func:`heads_spec` layout.  A projection's output is sharded over
    "model" along its last dimension, contiguous chunks that are whole
    heads only when the layout puts the heads over "model"; for the
    head_dim and replicated fallbacks (llama3.2-1b's 8 KV heads on a model
    axis of 16) the last dimension is gathered before the view and the
    result re-sliced."""
    B, S = t.shape[:2]
    spec = heads_spec(num_kv_heads, head_dim)
    if is_dtensor(t) and spec[2] is None:
        t = constrain(t, p_batch(None, None))
    return constrain(t.reshape(B, S, heads, head_dim), spec)


def split_head_weight(w, heads: int, head_dim: int):
    """A projection weight (r, heads · head_dim) → (r, heads, head_dim)
    for a per-head product (MLA's up-projections): the heads over "model"
    where the model axis divides them, else head_dim where it divides that,
    else replicated — :func:`split_heads`' rule, with no batch dimension.
    The rules shard the flat last dimension over "model", contiguous
    chunks that are whole heads only in the first case; otherwise it is
    gathered before the view and the view re-sliced.  The gradient is laid
    out by the view's layout in the first case and gathered in the others:
    the product's backward would leave it in a strided layout (a flattened
    head_dim shard, a batch reduction scattered over the heads) that the
    data-parallel reduction cannot redistribute."""
    r = w.shape[0]
    if not is_dtensor(w):
        return w.reshape(r, heads, head_dim)
    m = axis_size("model")
    if m > 1 and heads % m == 0:
        return constrain(w.reshape(r, heads, head_dim), P(None, "model", None), grad=True)
    w = constrain(w, P(None, None), grad=True).reshape(r, heads, head_dim)
    return constrain(w, P(None, None, "model" if m > 1 and head_dim % m == 0 else None))


def merge_heads(t):
    """(B, S, heads, hd) → (B, S, heads · hd): a head_dim-sharded layout
    is gathered over "model" first (a flattened dimension cannot keep a
    shard of its inner factor)."""
    B, S = t.shape[:2]
    if is_dtensor(t) and any(pl.is_shard(3) for pl in t.placements):
        t = constrain(t, p_batch(None, None, None))
    return t.reshape(B, S, -1)


def shard_cache_kv(cache_kv):
    """KV cache (B, S, KV, hd): batch over data; KV heads over "model" when
    divisible, else head_dim over "model", else replicated."""
    if not mesh_axes():
        return cache_kv
    _, _, KV, hd = cache_kv.shape
    return constrain(cache_kv, heads_spec(KV, hd))


# matched against the '/'-joined tree path; first hit wins.  Axes are
# logical: "model" = TP, "data" = FSDP (parameters gathered on use).
_RULES = [
    # embeddings / unembedding
    (r"embed/table$", ("model", "data")),  # (V, D)
    (r"lm_head$", ("data", "model")),  # (D, V)
    (r"pos_table$", (None, "data")),
    # attention (GQA)
    (r"(wq|wk|wv)$", ("data", "model")),
    (r"wo$", ("model", "data")),
    (r"(bq|bk|bv)$", ("model",)),
    # MLA
    (r"w_dkv$", ("data", None)),
    (r"w_kr$", ("data", None)),
    (r"w_dq$", ("data", None)),
    (r"(w_uk|w_uv|w_uq)$", (None, "model")),
    (r"(kv_norm|q_norm)$", (None,)),
    # MoE (leading expert dim) — must precede the generic MLP rules
    (r"experts/(w_gate|w_in)$", ("model", "data", None)),
    (r"experts/w_out$", ("model", None, "data")),
    (r"router$", ("data", None)),
    # MLPs
    (r"(w_gate|w_in)$", ("data", "model")),
    (r"w_out$", ("model", "data")),
    (r"(b_in)$", ("model",)),
    (r"(b_out)$", (None,)),
    # Mamba2
    (r"in_proj$", ("data", "model")),
    (r"out_proj$", ("model", "data")),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"(A_log|dt_bias|D)$", (None,)),
    (r"out_norm$", ("model",)),
    # norms & leftovers
    (r"(scale|bias)$", (None,)),
]


def param_spec(path: str, ndim: int, stacked_dims: int = 0) -> P:
    """The spec of a parameter at '/'-joined ``path``; ``stacked_dims``
    leading layer-stacking dimensions stay unsharded before the rule."""
    live = set(mesh_axes())
    for pat, axes in _RULES:
        if re.search(pat, path):
            body_ndim = ndim - stacked_dims
            resolved = [a if a is not None and a in live else None for a in axes[:body_ndim]]
            resolved += [None] * (body_ndim - len(resolved))
            return P(*([None] * stacked_dims), *resolved)
    return P(*([None] * ndim))


def _specs_by_path(tree, spec_of):
    paths, leaves = tree_flatten_with_paths(tree)
    return tree_unflatten(tree, [spec_of(p, x) for p, x in zip(paths, leaves)])


def params_shardings(params, stacked_paths=()):
    """A tree of specs matching ``params`` (tensors, meta tensors or
    anything with ``ndim``).  ``stacked_paths``: regex → the number of
    leading layer-stacking dimensions of the leaves it matches
    (``ModelBundle.stacked_paths``)."""
    stacked_paths = dict(stacked_paths)

    def spec(path, leaf):
        stacked = next((n for pat, n in stacked_paths.items() if re.search(pat, path)), 0)
        return param_spec(path, getattr(leaf, "ndim", 0), stacked)

    return _specs_by_path(params, spec)


def params_for_use(params, stacked_paths=()):
    """The parameters as the layers use them: a DTensor leaf sharded over
    the data axes (the rules' "data" = FSDP) all-gathered over them,
    keeping its "model" shards — the reference's "parameters gathered on
    use".  Its backward reduce-scatters the gradient back onto the data
    shards, which is the data-parallel reduction.  Plain leaves as they
    are.  Leaves whose '/'-joined path matches a regex of ``stacked_paths``
    (``ModelBundle.stacked_paths``) are left sharded: a training forward
    gathers each layer of a stack inside its body, as the reference's
    scan body does."""
    from torch.distributed.tensor import Replicate

    def use(path, x):
        if not is_dtensor(x) or any(re.search(pat, path) for pat in stacked_paths):
            return x
        names = x.device_mesh.mesh_dim_names
        target = [Replicate() if a in BATCH_AXES else pl for a, pl in zip(names, x.placements)]
        return x if list(x.placements) == target else x.redistribute(x.device_mesh, target)

    return _specs_by_path(params, use)


def shard_q_like_cache(q, num_kv_heads):
    """Constrain decode-time q (B, S, H, hd) to the KV cache's model-axis
    layout (KV heads over "model" when divisible, else head_dim), so that
    attention reads the cache where it lies."""
    if not mesh_axes():
        return q
    m = axis_size("model")
    _, _, H, hd = q.shape
    if m > 1 and num_kv_heads % m == 0 and H % m == 0:
        spec = p_batch(None, "model", None)
    elif m > 1 and hd % m == 0:
        spec = p_batch(None, None, "model")
    else:
        return q
    return constrain(q, spec)


_CACHE_LAYOUTS = {
    # trailing-dim layouts by leaf name
    "k": ("B", "T", "KV", "hd"),
    "v": ("B", "T", "KV", "hd"),
    "self_k": ("B", "T", "KV", "hd"),
    "self_v": ("B", "T", "KV", "hd"),
    "cross_k": ("B", "T", "KV", "hd"),
    "cross_v": ("B", "T", "KV", "hd"),
    "attn_k": ("B", "T", "KV", "hd"),
    "attn_v": ("B", "T", "KV", "hd"),
    "c_kv": ("B", "T", "r"),
    "k_rope": ("B", "T", "r"),
    "conv": ("B", "w", "ch"),
    "ssd": ("B", "H", "dh", "ds"),
}


def cache_shardings(cache):
    """The spec tree of a decode cache (tensors or anything with
    ``shape``): batch over the data axes when divisible, else — batch-1
    long-context cells — a KV cache's sequence over "data"; KV heads (or
    channels) over "model" when divisible, else head_dim."""
    live = set(mesh_axes())
    m = axis_size("model")
    dsz = 1
    for a in batch_axes():
        dsz *= axis_size(a)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        layout = _CACHE_LAYOUTS.get(path.split("/")[-1])
        if layout is None or not live:
            return P(*([None] * len(shape)))
        lead = len(shape) - len(layout)
        dims = shape[lead:]
        out = [None] * len(layout)
        batch_sharded = dims[layout.index("B")] % dsz == 0 and dsz > 1
        if batch_sharded:
            out[layout.index("B")] = batch_axes()
        for i, (ax, size) in enumerate(zip(layout, dims)):
            if ax == "T" and not batch_sharded and "data" in live and size % axis_size("data") == 0:
                out[i] = "data"
            if ax in ("KV", "H", "ch") and m > 1 and size % m == 0 and "model" in live:
                out[i] = "model"
            if ax == "hd" and out[layout.index("KV")] is None and m > 1 and size % m == 0:
                out[i] = "model"
        return P(*([None] * lead), *out)

    return _specs_by_path(cache, spec)


_REDUCE_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "product": "PRODUCT", "avg": "SUM"}
_SYNC_OPS = ("wait_tensor", "all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
             "broadcast", "all_to_all_single")


def _sync_collective(func, args, kwargs):
    """One of DTensor's functional collectives (``_c10d_functional``), run
    through c10d's synchronous API on plain tensors: the result tensor."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = func._schema.name.split("::")[-1]
    a = {arg.name: v for arg, v in zip(func._schema.arguments, args)}
    a.update(kwargs)
    if name == "wait_tensor":
        return a["tensor"]
    group = _resolve_process_group(a["group_name"])
    n = dist.get_world_size(group)
    me = dist.get_group_rank(group, dist.get_rank())
    x = a["input"].contiguous()
    if name in ("all_reduce", "reduce_scatter_tensor"):
        out = x.clone()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, _REDUCE_OPS[a["reduce_op"]]), group=group)
        if a["reduce_op"] == "avg":
            out = out / n
        if name == "reduce_scatter_tensor":
            out = out.chunk(n, dim=0)[me].contiguous()
        return out
    if name == "all_gather_into_tensor":
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    if name == "broadcast":
        out = x.clone()
        dist.broadcast(out, src=dist.get_global_rank(group, a["src"]), group=group)
        return out
    # all_to_all_single: every rank's splits and input gathered (the inputs
    # padded to the longest), this rank's split of each kept
    sizes = torch.tensor(list(a["input_split_sizes"]) or [x.shape[0] // n] * n, dtype=torch.int64)
    every = [torch.empty_like(sizes) for _ in range(n)]
    dist.all_gather(every, sizes, group=group)
    every = [s.tolist() for s in every]
    rows = max(sum(s) for s in every)
    pad = x.new_zeros((rows,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(n)]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[sum(s[:me]):sum(s[:me + 1])] for p, s in zip(parts, every)], dim=0)


@contextmanager
def sync_collectives():
    """While open, DTensor's functional collectives run through c10d's
    synchronous API (``all_reduce``, ``all_gather_into_tensor``,
    ``broadcast``, ``all_gather``): on torch 2.11 a functional collective
    on CUDA tensors over gloo crashes the process in its wait (ROADMAP
    Queue C), while those calls take them.  Gloo has no average and no
    all-to-all: the average is a sum divided by the group size, the
    all-to-all an all-gather sliced, and the reduce-scatter an all-reduce
    sliced — the same values, more bytes."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(is_dtensor(a) for a in _flat_tensors((args, kwargs))):
                return NotImplemented  # DTensor runs it; its local ops come back here
            if func.namespace == "_c10d_functional":
                name = func._schema.name.split("::")[-1]
                if name in _SYNC_OPS:
                    return _sync_collective(func, args, kwargs)
                if name.endswith(("_coalesced", "_")) or "gather" in name or "reduce" in name:
                    raise NotImplementedError(f"sync_collectives: {func} has no synchronous "
                                              "form here")
            return func(*args, **kwargs)

    with _Mode():
        yield


def _flat_tensors(tree):
    from torch.utils._pytree import tree_leaves

    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Mesh
    spec: P

    tree_leaf = True

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh.axis_names, self.mesh.shape)


def named_shardings(mesh, spec_tree):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def distribute(x: torch.Tensor, sharding: NamedSharding):
    """``x`` (the same global tensor on every rank) as a DTensor laid out
    by ``sharding``, each rank keeping its own shard (no communication):
    the reference's ``jax.device_put(x, sharding)``."""
    from torch.distributed.tensor import distribute_tensor

    dm = sharding.mesh.device_mesh(x.device.type)
    return distribute_tensor(x, dm, sharding.placements, src_data_rank=None)


def distribute_tree(tree, shardings):
    """:func:`distribute` leaf by leaf over a tree and its sharding tree."""
    return tree_map(distribute, tree, shardings)


# --- worlds ----------------------------------------------------------------


def rank_device(local_rank: int) -> torch.device:
    """A rank's card: ``cuda:(local_rank % device_count)``."""
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_from_env(backend: str = "nccl") -> int:
    """Join the world ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``); under NCCL the rank
    takes its card first.  Returns the rank."""
    if backend == "nccl":
        torch.cuda.set_device(rank_device(int(os.environ.get("LOCAL_RANK", "0"))))
    dist.init_process_group(backend, init_method="env://")
    return dist.get_rank()


def _rank_main(fn, rank, world, backend, init_file, args, threads, timeout, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank_device(rank))
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                                rank=rank, timeout=timedelta(seconds=timeout))
        out = fn(rank, world, *args)
        dist.barrier()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn, world: int, backend: str = "gloo", init_file: str | None = None, *,
                args=(), timeout: float = 120.0, threads: int | None = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined by
    ``torch.distributed`` (``file://`` rendezvous on ``init_file``, by
    default in a new temporary directory: no port is taken, so worlds can
    run side by side), and return the ranks' results in rank order.

    ``fn`` and its results must pickle (a module-level function).  Under
    NCCL each rank takes ``rank_device(rank)``; ``threads`` sets the ranks'
    torch threads.  The world runs under ``timeout`` seconds: a rank that
    raises, or a world still running at the deadline (a hung collective),
    kills every rank and raises here."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="world_")
        init_file = os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, init_file, tuple(args), threads, timeout,
                               results))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    out, failures = {}, []
    try:
        for p in procs:
            p.start()
        while len(out) + len(failures) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"world of {world} ({backend}) still running after "
                                   f"{timeout} s; ranks reported: {sorted(out)}")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"rank process exited with {dead[0].exitcode} "
                                       "before reporting")
                continue
            if ok:
                out[rank] = value
            else:
                failures.append(f"rank {rank}:\n{value}")
                break
        if failures:
            raise RuntimeError("world failed\n" + "\n".join(failures))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)

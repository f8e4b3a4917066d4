"""The GP system's multi-device layer on ``torch.distributed`` (counterpart
of the GP part of ``repro.distributed.sharding``).

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
import shutil
import tempfile
import threading
import time
import traceback
from contextlib import contextmanager
from datetime import timedelta

import torch
import torch.distributed as dist

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

    def __repr__(self):
        return f"Mesh({self.shape}, {self.axis_names}, rank={self.rank}, {self.backend})"


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

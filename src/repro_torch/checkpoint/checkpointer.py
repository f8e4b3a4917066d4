"""Atomic, async checkpointing with elastic restore — the counterpart of
``repro.checkpoint.checkpointer``, in the same on-disk layout, so that a
checkpoint written by either package restores in the other:

    <dir>/step_<N>/
        index.json        — {"step", "paths", "leaves": [{"shape", "dtype"}]}
        leaf_<i>.npy      — one file per leaf (host values), in the
                            reference's leaf order (:mod:`repro_torch.tree`)
    <dir>/step_<N>.COMMIT — written last: a checkpoint without its COMMIT
                            marker is incomplete and ignored.

numpy has no bfloat16: a bf16 leaf is stored as its ``u2`` bit pattern
with ``"bfloat16"`` in the index (the reference's ``ml_dtypes`` view), and
read back as a bf16 view of those bits — no ``ml_dtypes`` here.

Leaves are stored whole on the host; ``restore`` places them on the
device asked for, or on the device of the matching leaf of ``like``, or —
elastic restore — laid out on a mesh by ``shardings`` (a checkpoint
written from 4 ranks restores on 1, or on (2, 2) with other placements).
A tree of DTensors is gathered leaf by leaf before it is written (a
collective every rank enters) and rank 0 writes it.

``save_async`` copies every leaf to host memory before it returns (so the
caller may update its tensors in place at once) and writes the files on a
daemon thread.  One writer at a time: ``save`` too waits for a write in
flight (the reference's does not, and a train loop whose last step is a
checkpoint step wrote the same directory from two threads).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.sharding import distribute_tree, is_dtensor
from ..tree import tree_flatten_with_paths, tree_leaves, tree_unflatten

_TORCH_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int32": torch.int32, "int64": torch.int64,
                 "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _to_host(leaf):
    """(a host copy of the leaf, its dtype name); a DTensor leaf whole."""
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NAMES:
            raise TypeError(f"Checkpointer: cannot store a {leaf.dtype} leaf")
        return leaf.detach().to("cpu", copy=True), _NAMES[leaf.dtype]
    arr = np.array(leaf)  # a copy
    return arr, str(arr.dtype)


def _as_numpy(host):
    """A host copy as the array that goes into the .npy file."""
    if isinstance(host, torch.Tensor):
        if host.dtype == torch.bfloat16:  # its bit pattern, as the reference's u2 view
            return host.view(torch.int16).numpy().view(np.uint16)
        return host.numpy()
    return host


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def _snapshot(self, tree):
        """(paths, host copies, whether this process writes): a tree
        holding DTensors is written by rank 0 alone."""
        paths, leaves = tree_flatten_with_paths(tree)
        writes = not any(is_dtensor(x) for x in leaves) or dist.get_rank() == 0
        return paths, [_to_host(leaf) for leaf in leaves], writes

    def save(self, step: int, tree):
        self.wait()  # one writer at a time (the same step may be in flight)
        paths, host, writes = self._snapshot(tree)
        if writes:
            self._write(step, paths, host)

    def save_async(self, step: int, tree):
        self.wait()  # one writer at a time
        paths, host, writes = self._snapshot(tree)
        if writes:
            self._thread = threading.Thread(target=self._write, args=(step, paths, host),
                                            daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, paths, host):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        index = {"step": step, "paths": paths, "leaves": []}
        for i, (leaf, dtype_name) in enumerate(host):
            arr = _as_numpy(leaf)
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
            index["leaves"].append({"shape": list(arr.shape), "dtype": dtype_name})
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        open(final + ".COMMIT", "w").close()  # atomic completeness marker
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir, f"step_{s}.COMMIT"))
            except FileNotFoundError:
                pass

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and name.endswith(".COMMIT"):
                out.append(int(name[len("step_") : -len(".COMMIT")]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, device=None, shardings=None):
        """The checkpoint of ``step`` in the structure of ``like``, leaf by
        leaf in leaf order, each on ``device`` (default: the device of the
        matching leaf of ``like``, the CPU where that is no tensor), and
        with ``shardings`` (a tree of ``NamedSharding`` of ``like``'s
        structure) laid out on their mesh as DTensors: elastic resharding,
        each rank keeping its own shard of the whole leaf it read."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        _, like_leaves = tree_flatten_with_paths(like)
        if len(index["leaves"]) != len(like_leaves):
            raise ValueError(f"checkpoint/model structure mismatch: {len(index['leaves'])} "
                             f"leaves in step {step}, {len(like_leaves)} in the structure")
        leaves = []
        for i, (meta, ref) in enumerate(zip(index["leaves"], like_leaves)):
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
            want = meta["dtype"]
            if want == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            elif want in _TORCH_DTYPES:
                t = torch.from_numpy(arr.astype(want, copy=False))
            else:
                raise TypeError(f"checkpoint leaf {i} ({index['paths'][i]}): dtype {want}")
            if isinstance(ref, torch.Tensor) and tuple(ref.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint leaf {i} ({index['paths'][i]}) has shape "
                                 f"{tuple(t.shape)}, the structure {tuple(ref.shape)}")
            dev = device if device is not None else (
                ref.device if isinstance(ref, torch.Tensor) else "cpu")
            leaves.append(t.to(dev))
        if shardings is not None:
            leaves = tree_leaves(distribute_tree(tree_unflatten(like, leaves), shardings))
        return tree_unflatten(like, leaves)

    def restore_latest(self, like, device=None, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, device, shardings)

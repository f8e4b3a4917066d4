"""Production meshes — the counterpart of ``repro.launch.mesh``: the
reference's shapes and axis names, over the initialised
``torch.distributed`` world (256 or 512 ranks: a ``torchrun`` job, or the
dry-run's fake process group)."""

from __future__ import annotations

from ..distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 single pod (256 ranks) or 2×16×16 dual pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """A small mesh over a test world of prod(shape) ranks."""
    return Mesh(shape, axes)

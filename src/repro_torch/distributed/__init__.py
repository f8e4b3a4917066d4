"""Multi-device BBMM on ``torch.distributed`` (counterpart of the GP part of
``repro.distributed``): the mesh, the ambient-mesh context, row bands, the
two collectives and a world launcher for tests (see :mod:`.sharding`); and
the fault layer of LM training, :mod:`.fault` (preemption, the straggler
watchdog, the restart loop)."""

from .fault import PreemptionHandler, StragglerWatchdog, restart_loop
from .sharding import (
    Mesh,
    all_gather,
    all_gather_rows,
    batch_axes,
    collective_counts,
    current_mesh,
    init_from_env,
    make_mesh,
    mesh_axes,
    mesh_axis_sizes,
    ordered_psum,
    rank_device,
    reset_collective_counts,
    row_band,
    spawn_world,
    use_mesh,
)

__all__ = [
    "Mesh",
    "PreemptionHandler",
    "StragglerWatchdog",
    "all_gather",
    "all_gather_rows",
    "batch_axes",
    "collective_counts",
    "current_mesh",
    "init_from_env",
    "make_mesh",
    "mesh_axes",
    "mesh_axis_sizes",
    "ordered_psum",
    "rank_device",
    "reset_collective_counts",
    "restart_loop",
    "row_band",
    "spawn_world",
    "use_mesh",
]

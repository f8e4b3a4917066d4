"""The process and the card: what a run needs of them and reports about
them."""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch

#: top-level module names that may not be loaded in a run of the port
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def require_cards(count: int) -> None:
    """Exit, printing no result, unless ``count`` CUDA devices are here."""
    if not torch.cuda.is_available():
        print("gpbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        raise SystemExit(3)
    if torch.cuda.device_count() < count:
        print(f"gpbench: the cell needs {count} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        raise SystemExit(3)


def process_start() -> float:
    """The epoch second this process started (Linux' /proc), or now."""
    try:
        stat = Path(f"/proc/{os.getpid()}/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])  # starttime, the 22nd field
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def loaded_forbidden() -> list:
    """Forbidden packages in ``sys.modules``, by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count()))


def device_record(device, count: int) -> dict:
    cuda = torch.device(device).type == "cuda"
    return {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": count,
        "memory_peak_bytes": memory_peak(device),
    }

"""The system under test, the port ``repro_torch``, and the inputs the
benchmark makes for it.

The program is imported from the checkout's ``src/``; nothing of it is
imported before a run has found its card.  Its CUDA libraries are built by
its own build module into its fixed cache inside the checkout
(``src/repro_torch/kernels/_build/``), so only the first run in a checkout
runs nvcc.  The LM kernels' libraries (flash attention, the SSD scan) are
marked as not built: no GP cell launches them, and nvcc would otherwise
compile them in the first run.
"""

from __future__ import annotations

import hashlib
import math
import os
import sys

import torch

from .spec import ROOT

SRC = ROOT / "src"
#: libraries of kernels that no GP cell launches
UNUSED_LIBRARIES = ("flash_attention", "ssd_scan")
CACHE_DIR = ROOT / ".gpbench_cache"


def import_program():
    """The port's package; raises ImportError where the checkout lacks it."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE_DIR / "torch_extensions"))
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import repro_torch

    _skip_unused_libraries()
    return repro_torch


def _skip_unused_libraries() -> None:
    """The port builds all its libraries at the first load and offers no
    public way to build some; its private table of builds is marked."""
    from repro_torch.kernels import build

    for name in UNUSED_LIBRARIES:
        build._infos.setdefault(name, build.BuildInfo(
            path=build._library_path(name), seconds=0.0, log="not built: no GP cell launches it"))


def exact_gp(config: dict, stage: str, device):
    """``ExactGP`` as ``config`` states it, with the BBMM settings of
    ``stage`` ("training" or "serving")."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings

    s = config[stage]
    settings = BBMMSettings(
        num_probes=s["num_probes"], max_cg_iters=s["max_cg_iters"], cg_tol=s["cg_tol"],
        precond_rank=s["precond_rank"], fuse_cg=s["fuse_cg"], precision=config["precision"],
        cg_refresh_every=config["cg_refresh_every"],
    )
    return ExactGP(kernel_type=config["kernel_type"], mode=config["mode"], settings=settings,
                   device=device)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of inputs, from the run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def targets(X: torch.Tensor, eps: torch.Tensor, noise_std: float) -> torch.Tensor:
    """y = sin(3x₀)·cos(2x_{d−1}) + noise_std·ε."""
    return torch.sin(3 * X[:, 0]) * torch.cos(2 * X[:, -1]) + noise_std * eps


def make_rows(n: int, config: dict, gen: torch.Generator, device):
    """n rows of the configuration's data (X ~ U(−1, 1)^d), on the device."""
    d = config["d"]
    X = torch.rand((n, d), generator=gen, device=device) * 2 - 1
    eps = torch.randn((n,), generator=gen, device=device)
    return X, targets(X, eps, config["noise_std"])


def raw_hyperparameters(values: dict) -> dict:
    """The program's raw (softplus-inverse) leaves from constrained values."""
    return {f"raw_{k}": math.log(math.expm1(v)) for k, v in values.items()}

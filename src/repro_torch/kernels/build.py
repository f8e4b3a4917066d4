"""Build and load the CUDA kernel libraries of this package.

Every ``<kernel>/csrc/*.cu`` under this directory is compiled with ``nvcc``
for ``sm_90a`` into a shared library of its own with a plain C interface,
loaded with ctypes:

  * ``kernel_matmul/csrc/kernel_matmul.cu``      — B1/B2, the kernel-matrix matmul;
  * ``kernel_matmul/csrc/fused_cg_step.cu``      — B3, one fused mBCG iteration;
  * ``kernel_matmul/csrc/kernel_matmul_grad.cu`` — the matmul's gradient;
  * ``kernel_matmul/csrc/kernel_matmul_bf16.cu`` — B1/B2 with bf16 operands
    (``precision="mixed"``);
  * ``kernel_matmul/csrc/fused_cg_step_bf16.cu`` — B3 with bf16 operands;
  * ``flash_attention/csrc/flash_attention.cu``  — B4, flash attention;
  * ``ssd_scan/csrc/ssd_scan.cu``                — B5, the Mamba-2 SSD scan.

The kernel-matrix sources include ``kernel_matmul/csrc/tf32_tile.cuh``
(B1's tensor-core tile loop and its helpers) and ``common.cuh``; B1's and
B3's, in f32 and bf16, also ``epilogues.cuh`` (their stores), and the two
bf16 ones ``bf16_tile.cuh`` (the bf16 tile loop), so those headers are
compiled into several libraries.

The build happens at first use, into ``_build/`` beside this file
(gitignored), one ``nvcc`` process per source, all started together.  Each
library's name carries one hash of every source and header under the
``csrc/`` directories and of the flags, so editing any of them rebuilds and
a stale library is never loaded.  Nothing is downloaded; a failed build
raises :class:`KernelBuildError`, and a wrapper whose launch returns a CUDA
error raises :class:`KernelLaunchError`.

:func:`build_all` and :func:`load_library` run under one module lock, so
threads that reach a kernel for the first time together (the serving
session's query workers and its refresher) build each library once and
load it once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).parent
BUILD_DIR = KERNELS_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

#: The C entry point of each library and its ctypes signature.  Pointers
#: and the stream are c_void_p, never the 32-bit default.
ENTRY_POINTS = {
    # X1, X2, M, scal, out; rows, cols, d, t, batch, row_offset,
    # kernel_type; stream
    "kernel_matmul": ("kernel_matmul_f32", [_P] * 5 + [_I] * 7 + [_P]),
    # X1, X2, U, R, D, V, Rc, Dc, Vc, abg, scal, Uo, Ro, Do, Vo, partial,
    # red; rows, cols, d, t, batch, row_offset, kernel_type; stream
    "fused_cg_step": ("fused_cg_step_f32", [_P] * 17 + [_I] * 7 + [_P]),
    # X1, X2, A, B, scal, G, partial, gsum; rows, cols, d, t, kernel_type;
    # stream
    "kernel_matmul_grad": ("kernel_matmul_grad_f32", [_P] * 8 + [_I] * 5 + [_P]),
    # X1, X2, Mb (bf16), scal, out; rows, cols, d, t, tp, batch, row_offset,
    # kernel_type; stream
    "kernel_matmul_bf16": ("kernel_matmul_bf16", [_P] * 5 + [_I] * 8 + [_P]),
    # X1, X2, U, R, D, V, Rc, Dc, Vc, abg, scal, Uo, Ro, Do, Vo, partial,
    # Db (bf16), red; rows, cols, d, t, tp, batch, row_offset, kernel_type;
    # stream
    "fused_cg_step_bf16": ("fused_cg_step_bf16", [_P] * 18 + [_I] * 8 + [_P]),
    # q, k, v, o, strides (host int64[12]); dtype, b, hq, hkv, sq, skv, dh;
    # scale; causal; stream
    "flash_attention": ("flash_attention_fwd", [_P] * 5 + [_I] * 7 + [_F, _I, _P]),
    # x, dt, A, B, C, y, strides (host int64[13]); dtype, b, h, l, dh, ds,
    # chunk; stream
    "ssd_scan": ("ssd_scan_fwd", [_P] * 7 + [_I] * 7 + [_P]),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelLaunchError(RuntimeError):
    """A kernel's entry point returned a CUDA error: a fault of the kernel
    or of the card, never of the numbers it was given."""


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of the nvcc call; 0.0 when the library existed
    log: str  # nvcc's output (ptxas register / shared-memory report)


_libs: dict[str, ctypes.CDLL] = {}
_infos: dict[str, BuildInfo] = {}
# guards _infos and _libs; reentrant, since load_library builds
_lock = threading.RLock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "are built from source at first use and need the CUDA toolkit"
    )


def _csrc_files() -> list[Path]:
    return sorted(
        p for p in KERNELS_DIR.glob("*/csrc/*") if p.suffix in (".cu", ".cuh")
    )


def source(name: str) -> Path:
    """The ``.cu`` file of library ``name`` (a key of :data:`ENTRY_POINTS`)."""
    found = [p for p in _csrc_files() if p.name == f"{name}.cu"]
    if len(found) != 1:
        raise KernelBuildError(f"expected one source {name}.cu under */csrc/, found {found}")
    return found[0]


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for src in _csrc_files():
        rel = src.relative_to(KERNELS_DIR).as_posix()
        h.update(rel.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:12]


def _library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest()}.so"


def _check_sources() -> None:
    """Every ``csrc/*.cu`` has an entry point and every entry point a source."""
    sources = {p.stem for p in _csrc_files() if p.suffix == ".cu"}
    if sources != set(ENTRY_POINTS):
        raise KernelBuildError(
            f"kernel sources {sorted(sources)} and entry points "
            f"{sorted(ENTRY_POINTS)} differ"
        )


def build_all() -> dict[str, BuildInfo]:
    """Compile every library whose build does not exist yet, one nvcc
    process per source, all running at once.  Concurrent callers wait for
    the one build."""
    with _lock:
        return _build_all_locked()


def _build_all_locked() -> dict[str, BuildInfo]:
    _check_sources()
    todo = {}
    for name in ENTRY_POINTS:
        if name in _infos:
            continue
        path = _library_path(name)
        if path.exists():
            _infos[name] = BuildInfo(path=path, seconds=0.0, log="")
        else:
            todo[name] = path
    if not todo:
        return dict(_infos)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, path in todo.items():
        # compile to a private name, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [
            nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(source(name)),
        ]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        try:
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{log}")
                continue
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        _infos[name] = BuildInfo(path=path, seconds=time.perf_counter() - t0, log=log)
    if errors:
        raise KernelBuildError("\n".join(errors))
    return dict(_infos)


def build(name: str) -> BuildInfo:
    """The build of one library (all of them are built together)."""
    return build_all()[name]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of :data:`ENTRY_POINTS`), built
    first if needed, with its C signature set."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name).path))
            symbol, argtypes = ENTRY_POINTS[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]

"""Build and load the CUDA kernel-matmul library.

The kernel is compiled from ``csrc/kernel_matmul.cu`` with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded with
ctypes.  The build happens at first use, into ``_build/`` beside this file
(gitignored), under a name that carries a hash of the source, so an edited
source is rebuilt and a stale library is never loaded.  Nothing is
downloaded; a failed build raises :class:`KernelBuildError`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SOURCE = Path(__file__).parent / "csrc" / "kernel_matmul.cu"
BUILD_DIR = Path(__file__).parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


#: ctypes signature of ``kernel_matmul_f32`` in the source: X1, X2, M, scal,
#: out, then rows, cols, d, t, batch, row_offset, kernel_type, then the
#: stream.  Pointers and the stream are c_void_p, never the 32-bit default.
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the kernel source."""


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # wall time of the nvcc call; 0.0 when the library existed
    log: str  # nvcc's output (ptxas register / shared-memory report)


_lib: ctypes.CDLL | None = None
_info: BuildInfo | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernel "
        "matmul is built from source at first use and needs the CUDA toolkit"
    )


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libkernel_matmul-{digest.hexdigest()[:12]}.so"


def build() -> BuildInfo:
    """Compile the library unless this source's build already exists."""
    global _info
    if _info is not None:
        return _info
    path = _library_path()
    if path.exists():
        _info = BuildInfo(path=path, seconds=0.0, log="")
        return _info
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(SOURCE),
    ]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _info = BuildInfo(
        path=path, seconds=time.perf_counter() - t0, log=proc.stdout + proc.stderr
    )
    return _info


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed, with its C signature set
    (:data:`ARGTYPES`)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        fn = lib.kernel_matmul_f32
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib

"""The port stands alone, and runs on the GPU unless told otherwise.

* No module of ``src/repro_torch`` — and not ``chip_smoke.py``, which drives
  it on the GPU machine, nor the port's examples (``examples/torch_*.py``),
  nor its timing scripts (``scripts/*.py``) — imports ``jax`` or anything
  of the reference package ``repro``, not even its JAX-free modules.
* An entry point called without ``device="cpu"`` runs on CUDA, and raises
  when there is no GPU instead of carrying on quietly on the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import SKI, ExactGP, NoCudaDeviceError, params_from_jax, resolve_device

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("torch_*.py"))
              + sorted((ROOT / "scripts").glob("*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_files_were_found():
    names = {p.name for p in PORT_FILES}
    assert {"kernel_matmul.py", "mbcg.py", "exact.py", "ski.py", "sharding.py", "distributed.py",
            "chip_smoke.py", "torch_quickstart.py", "torch_large_scale_ski.py",
            "adam.py", "adafactor.py", "clipping.py", "schedules.py", "compression.py",
            "checkpointer.py", "fault.py", "train.py", "pipeline.py", "tree.py",
            "torch_train_gp_e2e.py", "torch_deep_kernel_lm.py", "torch_posterior_serving.py",
            "time_bf16_kernels.py", "time_f32_lm_kernels.py", "tf32.py"} <= names
    assert len(PORT_FILES) >= 20


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_imports(path):
    bad = [(mod, line) for mod, line in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_sets_true_f32_matmuls():
    assert repro_torch  # importing the package set the policy
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_default_to_cuda():
    """Without a GPU (as on the CPU test machines) the default raises; with
    one it is the GPU."""
    raw = {"raw_lengthscale": np.float32(0.0), "raw_outputscale": np.float32(0.0),
           "raw_noise": np.float32(-2.0)}
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert ExactGP().device.type == "cuda"
        assert SKI().device.type == "cuda"
        assert ExactGP(mode="cuda_sharded").device.type == "cuda"
        assert params_from_jax(raw)["raw_noise"].is_cuda
        return
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        ExactGP()
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        ExactGP(mode="cuda_sharded")
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        SKI(grid_size=16)
    assert SKI(device="cpu").device == torch.device("cpu")
    with pytest.raises(NoCudaDeviceError):
        ExactGP(mode="cuda", device="cuda")
    with pytest.raises(NoCudaDeviceError):
        params_from_jax(raw)
    assert ExactGP(device="cpu").device == torch.device("cpu")
    assert params_from_jax(raw, device="cpu")["raw_noise"].device == torch.device("cpu")


def test_lm_entry_points_default_to_cuda():
    """The LM serving entry points (``lm_params_from_jax``, the serve CLI's
    model build) run on CUDA unless told otherwise, and raise without a
    GPU."""
    from repro_torch import lm_params_from_jax
    from repro_torch.launch.serve import build_server

    tree = {"embed": {"table": np.zeros((4, 2), np.float32)}}
    if torch.cuda.is_available():
        assert lm_params_from_jax(tree)["embed"]["table"].is_cuda
        return
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        lm_params_from_jax(tree)
    with pytest.raises(NoCudaDeviceError):
        build_server("zamba2-7b", "cpu-small")
    out = lm_params_from_jax(tree, device="cpu")
    assert out["embed"]["table"].device == torch.device("cpu")


def test_lm_training_entry_point_defaults_to_cuda():
    """``launch.train`` (``run_training`` and ``main``) and the two training
    examples run on CUDA unless given ``--device cpu``, and raise without a
    GPU."""
    import importlib.util

    from repro_torch.launch import train

    argv = ["--preset", "cpu-small", "--steps", "1", "--batch", "2", "--seq", "8"]
    if torch.cuda.is_available():
        assert train.run_training(train.parse_args(argv)) == 0
        return
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        train.run_training(train.parse_args(argv))
    with pytest.raises(NoCudaDeviceError):
        train.main(argv)
    for name in ("torch_train_gp_e2e", "torch_deep_kernel_lm"):
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(NoCudaDeviceError):
            mod.run(n=32, steps=1)

"""The port's LM training driver, ``repro_torch.launch.train``, on the
CPU (``--preset cpu-small --device cpu``, the reduced llama3.2-1b), and the
two examples that need only the training substrate:

* the loss falls over the run;
* ``--crash-at`` through ``restart_loop`` resumes from the last complete
  checkpoint and ends on the uninterrupted run's bits (params and Adam
  moments of the final checkpoint);
* without ``--device cpu`` on a machine with no GPU it raises
  ``NoCudaDeviceError`` (with one, it trains on CUDA);
* an encoder–decoder gets stub frames from (seed, step);
* ``examples/torch_train_gp_e2e.py`` (SGPR, Adam, the checkpointer, the
  watchdog) and ``examples/torch_deep_kernel_lm.py`` (DKL over a 2-layer
  llama backbone) at a small n.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import NoCudaDeviceError
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.launch import train
from repro_torch.tree import tree_flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMALL = ["--preset", "cpu-small", "--device", "cpu", "--batch", "4", "--seq", "32"]


def test_loss_falls_on_the_cpu(capsys):
    log = []
    args = train.parse_args(SMALL + ["--steps", "30", "--log-every", "10"])
    assert train.run_training(args, log=log) == 29
    losses = [r["loss"] for r in log]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
    assert all(r["seconds"] > 0 and np.isfinite(r["grad_norm"]) for r in log)
    out = capsys.readouterr().out
    assert "step     0" in out and "[done] steps=30" in out


def _final_state(ckpt_dir, steps):
    ck = Checkpointer(str(ckpt_dir))
    assert ck.latest_step() == steps - 1
    d = Path(ckpt_dir) / f"step_{steps - 1}"
    return [np.load(d / f"leaf_{i}.npy") for i in range(len(list(d.glob("leaf_*.npy"))))]


def test_crash_resumes_to_the_uninterrupted_bits(tmp_path, capsys):
    steps = 9
    common = SMALL + ["--steps", str(steps), "--ckpt-every", "3", "--log-every", "1"]
    train.main(common + ["--ckpt-dir", str(tmp_path / "straight")])
    train.main(common + ["--ckpt-dir", str(tmp_path / "crashed"), "--crash-at", "5"])
    out = capsys.readouterr().out
    assert "[restart 1] after RuntimeError: injected crash" in out
    assert "[resume] restored step 3" in out
    ours, straight = _final_state(tmp_path / "crashed", steps), _final_state(tmp_path / "straight", steps)
    assert len(ours) == len(straight) > 10
    for a, b in zip(ours, straight):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert Checkpointer(str(tmp_path / "crashed")).all_steps() == [3, 6, 8]


def test_the_default_device_is_cuda():
    args = train.parse_args(["--preset", "cpu-small", "--steps", "1", "--batch", "2", "--seq", "8"])
    if torch.cuda.is_available():
        assert train.run_training(args) == 0
        return
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        train.run_training(args)
    with pytest.raises(NoCudaDeviceError):
        train.main(["--preset", "cpu-small", "--steps", "1"])


def test_encdec_batches_carry_frames_and_train():
    cfg = get_config("whisper-large-v3").reduced()
    stream = TokenStream(cfg.vocab_size, 2, 8, seed=3)
    b = train.training_batch(cfg, stream, 4, "cpu")
    assert b["tokens"].dtype == torch.int64 and b["tokens"].shape == (2, 9)
    assert b["frames"].shape == (2, cfg.encoder_seq, cfg.d_model)
    again = train.training_batch(cfg, stream, 4, "cpu")
    assert torch.equal(b["frames"], again["frames"]) and torch.equal(b["tokens"], again["tokens"])
    assert "frames" not in train.training_batch(get_config("llama3.2-1b").reduced(), stream, 4, "cpu")
    log = []
    args = train.parse_args(["--arch", "whisper-large-v3", "--preset", "cpu-small", "--device",
                             "cpu", "--steps", "3", "--batch", "2", "--seq", "8"])
    train.run_training(args, log=log)
    assert len(log) == 3 and all(np.isfinite(r["loss"]) for r in log)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_gp_e2e_example_on_the_cpu(tmp_path):
    """SGPR on 3,000 points, 60 steps: checkpoints at steps 25 and 50 (keep
    2), the loss falls, and the served mean meets the JAX example's bar."""
    ex = _example("torch_train_gp_e2e")
    out = ex.run(n=3_000, steps=60, device="cpu", ckpt_dir=str(tmp_path))
    assert out["checkpoints"] == [25, 50]
    assert out["losses"][-1] < out["losses"][0]
    assert out["mae"] < ex.MAE_BAR
    step, params = Checkpointer(str(tmp_path)).restore_latest(
        {"inducing": torch.zeros(128, 4), "raw_lengthscale": torch.zeros(()),
         "raw_outputscale": torch.zeros(()), "raw_noise": torch.zeros(())})
    assert step == 50 and tree_flatten_with_paths(params)[0] == [
        "inducing", "raw_lengthscale", "raw_noise", "raw_outputscale"]


def test_deep_kernel_lm_example_on_the_cpu():
    """The DKL-over-llama example at a small n and few steps: the MLL
    falls and the transformer weights receive its gradient (the bar, MAE <
    0.7, is the 150-step run's)."""
    ex = _example("torch_deep_kernel_lm")
    out = ex.run(n=64, steps=8, device="cpu")
    assert np.isfinite(out["mae"]) and out["last"] < out["first"]

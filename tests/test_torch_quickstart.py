"""examples/torch_quickstart.py, the port's quickstart, end to end on the
CPU at both precisions (its own file, so that a parallel run places its
two minutes of training beside the other files rather than behind them)."""

import runpy
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import SolveHealthWarning


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """720 points make small ops, which run fastest on one thread and spin
    on eight under a parallel test run (alone: 117 s on eight threads,
    65 s on one)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("precision", ["highest", "mixed"])
def test_torch_quickstart_meets_its_bar(precision):
    """examples/torch_quickstart.py end to end on the CPU: 80 Adam steps on
    720 points, then the JAX quickstart's bar, MAE < 0.35 (asserted by the
    script on the training; under "mixed" the mean served with bf16 operands
    is returned beside it)."""
    script = Path(__file__).resolve().parents[1] / "examples" / "torch_quickstart.py"
    main = runpy.run_path(str(script))["main"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SolveHealthWarning)
        mae, bar_mae = main(["--device", "cpu", "--precision", precision])
    assert bar_mae < 0.35 and np.isfinite(mae)
    if precision == "highest":
        assert mae == bar_mae

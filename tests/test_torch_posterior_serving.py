"""examples/torch_posterior_serving.py, the port's serving demo, end to end
on the CPU: a PosteriorSession over an ExactGP (n = 1,500, d = 2, 10
probes, 25 CG iterations, rank 5, max_staleness 8) serves 20 requests of
256 points, observes 2 new points and, after a rebuild, meets the
reference example's two assertions — the cached mean bitwise the
uncached ``predict``'s, the cached variance at least ``predict``'s − 2e-2
(asserted by the script; the figures it returns are checked here)."""

import runpy
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import SolveHealthWarning


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """1,500 points make small ops, which run fastest on one thread and spin
    on eight under a parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_torch_posterior_serving_meets_the_references_assertions():
    script = Path(__file__).resolve().parents[1] / "examples" / "torch_posterior_serving.py"
    main = runpy.run_path(str(script))["main"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SolveHealthWarning)
        out = main(["--device", "cpu"])
    assert out["mean_bitwise"] and out["n"] == 1502
    assert out["observe"] == "append"  # streamed, not rebuilt: staleness 1 of 8
    assert out["variance_slack"] <= 2e-2
    assert np.isfinite(out["streamed_vs_rebuilt"]) and out["query_ms"] > 0

"""On the card: one short run of each cell, judged correct.  Skips without
a CUDA device (decided in the fixture, never at import).

    python -m pytest -q -m cuda gpbench/tests/test_gpbench_card.py
"""

import warnings

import pytest
import torch

from gpbench.harness import cell as cells
from gpbench.harness.spec import Spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in Spec().benchmark["workloads"]])
def test_cell_on_the_card(card, name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = cells.run_cell(name, 2 ** 31 + 99, 3.0, False, device=card)
    assert r["correct"], r["compared"]
    assert r["device"]["platform"] == "gpu"

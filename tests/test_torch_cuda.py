"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: a
hand-written kernel has no CPU mode.  The file imports no JAX, so it runs on
the GPU machine, which has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.kernel_matmul import kernel_matmul as km
from repro_torch.kernels.kernel_matmul.ref import KERNEL_TYPES, kernel_matmul_plain

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed, n, d, shape_m, dev):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    ell = rng.uniform(0.4, 1.5, d).astype(np.float32)
    M = rng.standard_normal(shape_m).astype(np.float32)
    return torch.from_numpy(X / ell).to(dev), torch.from_numpy(M).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
@pytest.mark.parametrize("n,t", [(1001, 1), (1001, 9), (4097, 234), (1001, 256)])
def test_kernel_matches_plain(cuda_device, kernel_type, n, t):
    Xs, M = _inputs(n + t, n, 8, (n, t), cuda_device)
    before = km.launches
    out = km.kernel_matmul_cuda(Xs, Xs, M, 1.1, 0.1, kernel_type=kernel_type)
    torch.cuda.synchronize()
    assert km.launches == before + 1
    plain = kernel_matmul_plain(Xs, Xs, M, 1.1, 0.1, kernel_type=kernel_type)
    torch.testing.assert_close(out, plain, **TOL)


@pytest.mark.cuda
def test_row_offset_slices_and_batch(cuda_device):
    n = 3001
    Xs, M = _inputs(1, n, 5, (3, n, 7), cuda_device)
    full = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.3, kernel_type="matern32")
    parts = [
        km.kernel_matmul_cuda(Xs[i : i + 1000].contiguous(), Xs, M, 1.0, 0.3, i,
                              kernel_type="matern32")
        for i in range(0, n, 1000)
    ]
    torch.testing.assert_close(torch.cat(parts, dim=1), full, rtol=1e-5, atol=1e-5)
    for b in range(3):
        one = km.kernel_matmul_cuda(Xs, Xs, M[b], 1.0, 0.3, kernel_type="matern32")
        torch.testing.assert_close(full[b], one, rtol=1e-5, atol=1e-5)
    plain = kernel_matmul_plain(Xs, Xs, M, 1.0, 0.3, kernel_type="matern32")
    torch.testing.assert_close(full, plain, **TOL)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    Xs, M = _inputs(2, 64, 3, (64, 4), cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        km.kernel_matmul_cuda(Xs, Xs, M.T.contiguous().T, 1.0, 0.0)
    with pytest.raises(TypeError, match="float32"):
        km.kernel_matmul_cuda(Xs, Xs, M.double(), 1.0, 0.0)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        km.kernel_matmul_cuda(Xs, Xs.cpu(), M, 1.0, 0.0)

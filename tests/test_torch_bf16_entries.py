"""The bf16 kernels' entry formula and their staged X, on the CPU.

``ref.kernel_entries_bf16_plain`` writes down how bf16 B1/B2 and B3 form a
kernel entry: the distance's inner product from bf16 operands with exact
products and f32 sums, the norms the same way, d² = max(n1 + n2 − 2S, 0),
exactly 0 at coincident points (the kernels take the norms with the
instructions that take S), the stationary map, σ² on the global diagonal,
rounded to bf16.  The card's entries are held to it in ``chip_smoke.py``
(phase ``fused_kernel_bf16``); here the formula is held to the reference's
mixed tile (``_masked_kernel_tile(..., mxu_dtype=jnp.bfloat16)``) and to
the tile of the port's bf16 plain version.

Tolerance: one bf16 step, entry by entry.  The three round the same
function to bf16 but take its f32 value by other routes (sums in other
orders, the distance by the norm expansion or by differences, XLA's exp
or torch's), so an entry whose f32 value lies near a rounding boundary may
land on the neighbouring bf16 value, and no further.  Values below the
smallest normal f32 count as 0 (XLA's exp and the kernels' flush them,
torch's does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.kernel_matmul.kernel_matmul import _masked_kernel_tile
from repro_torch.kernels.kernel_matmul import kernel_matmul as km
from repro_torch.kernels.kernel_matmul.ref import (
    KERNEL_TYPES,
    kernel_entries_bf16_plain,
    kernel_matmul_plain,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, n, d, dup=True):
    """X/ℓ rounded to bf16 (as the mixed policy stores it), ARD, with two
    duplicated rows (coincident points off the diagonal)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32) / rng.uniform(0.5, 1.5, d).astype(np.float32)
    if dup:
        X[n - 2] = X[3]
        X[n // 2] = X[3]
    return torch.from_numpy(X).to(torch.bfloat16).float()


#: the smallest normal f32: the kernels' exp (and XLA's on the CPU) flush
#: results below it to 0, torch's does not
TINY = 2.0**-126


def _steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 values apart two tensors of non-negative bf16 values
    lie (consecutive values of one sign are consecutive bit patterns),
    values below TINY read as 0."""
    def bits(x):
        return x.masked_fill(x < TINY, 0.0).to(torch.bfloat16).view(torch.int16).int()
    return (bits(a) - bits(b)).abs()


@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
@pytest.mark.parametrize("n,d,off", [(101, 3, 0), (77, 8, 0), (151, 17, 23)])
def test_formula_matches_the_reference_mixed_tile(kernel_type, n, d, off):
    X = _inputs(n + d, n, d)
    X1 = X[off : off + 60]
    ours = kernel_entries_bf16_plain(X1, X, 1.3, 0.2, off, kernel_type=kernel_type)
    tile = _masked_kernel_tile(
        jnp.asarray(X1.numpy()), jnp.asarray(X.numpy()), jnp.asarray([1.3, 0.2], jnp.float32),
        off, 0, 0, kernel_type=kernel_type, bn=X1.shape[0], bm=n, n_cols=n,
        mxu_dtype=jnp.bfloat16,
    )
    ref = torch.from_numpy(np.asarray(tile))
    assert int(_steps(ours, ref).max()) <= 1


@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
@pytest.mark.parametrize("n,d,off", [(101, 3, 0), (77, 8, 5), (151, 33, 64)])
def test_formula_matches_the_plain_versions_tile(kernel_type, n, d, off):
    """The bf16 plain version's tile, read through identity columns (each
    output one bf16 entry times 1): within one bf16 step, and the same at
    coincident points and on the diagonal, where both are exact."""
    X = _inputs(2 * n + d, n, d)
    X1 = X[off : off + 50]
    ours = kernel_entries_bf16_plain(X1, X, 0.9, 0.3, off, kernel_type=kernel_type)
    plain = kernel_matmul_plain(X1, X, torch.eye(n), 0.9, 0.3, off, kernel_type=kernel_type,
                                compute_dtype="bfloat16")
    assert int(_steps(ours, plain).max()) <= 1
    exact = torch.cdist(X1.double(), X.double()) == 0
    assert bool(exact.any())
    assert torch.equal(ours[exact], plain[exact])


@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
def test_formula_is_exact_at_coincident_points_and_on_the_diagonal(kernel_type):
    X = _inputs(9, 130, 5)
    K = kernel_entries_bf16_plain(X, X, 0.75, 0.5, kernel_type=kernel_type)
    assert bool((K.diagonal() == 1.25).all())
    assert float(K[3, 65]) == float(K[65, 3]) == float(K[3, 128]) == 0.75
    assert bool((K <= 0.75).masked_fill(torch.eye(130, dtype=torch.bool), True).all())


@pytest.mark.parametrize("d", [1, 8, 16, 17, 40])
def test_staging_round_trips_bf16_values(d):
    """The staged copy holds bf16-valued X exactly, padded with zeros to a
    multiple of 16 features; a row slice reads its rows of the base's copy;
    an in-place write of X stages it anew."""
    X = _inputs(d, 70, d, dup=False)
    S = km.stage_bf16(X)
    assert S.dtype == torch.bfloat16 and S.is_contiguous()
    assert S.shape == (70, -(-d // 16) * 16)
    assert torch.equal(S[:, :d].float(), X)
    assert bool((S[:, d:] == 0).all())
    assert km.stage_bf16(X).data_ptr() == S.data_ptr()  # staged once
    panel = km.stage_bf16(X[20:45])
    assert panel.data_ptr() == S[20:45].data_ptr() and torch.equal(panel.float()[:, :d], X[20:45])
    X.mul_(2.0)
    again = km.stage_bf16(X)
    assert again.data_ptr() != S.data_ptr() and torch.equal(again[:, :d].float(), X)

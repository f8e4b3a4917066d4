"""The port's CUDA kernels against their plain PyTorch versions, on the card:
B1/B2 (the kernel matmul), B3 (the fused CG step), the gradient kernel,
B4 (flash attention) and B5 (the SSD scan), the training path through the
first three and the zamba2 forward through the last two; B1/B2 and B3 also
with bf16 operands (``precision="mixed"``) and the mixed GP paths' launches;
B2's gradient and the partitioned path's panel streams (B1/B2, B3 and the
gradient kernel once per row panel) against their full-range launches.

Every test here is marked ``cuda`` and skips without a CUDA device: a
hand-written kernel has no CPU mode.  The file imports no JAX, so it runs on
the GPU machine, which has none:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.kernel_matmul import kernel_matmul as km
from repro_torch.kernels.kernel_matmul.ref import (
    KERNEL_TYPES,
    fused_cg_step_plain,
    kernel_matmul_grad_plain,
    kernel_matmul_grad_sym_plain,
    kernel_matmul_plain,
)

TOL = dict(rtol=2e-4, atol=2e-4)
RED_TOL = dict(rtol=2e-4, atol=2e-3)  # the reductions, as tests/test_fused_cg.py:86


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
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("t", [1, 8, 9, 16, 17, 234, 256, 257, 512])
def test_kernel_column_blocks_match_plain(cuda_device, t, batch):
    """Every column-block width of the tensor-core kernel (16 to 256, and a
    second 256-column block past 256), 2-D and batched M, at 2e-4."""
    n = 777
    shape = (n, t) if batch is None else (batch, n, t)
    Xs, M = _inputs(t, n, 8, shape, cuda_device)
    out = km.kernel_matmul_cuda(Xs, Xs, M, 1.1, 0.1, kernel_type="matern52")
    torch.cuda.synchronize()
    plain = kernel_matmul_plain(Xs, Xs, M, 1.1, 0.1, kernel_type="matern52")
    torch.testing.assert_close(out, plain, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [9, 256])
def test_kernel_row_offset_slices_reassemble(cuda_device, t):
    n = 2500
    Xs, M = _inputs(7 + t, n, 8, (n, t), cuda_device)
    full = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.2, kernel_type="rbf")
    parts = [
        km.kernel_matmul_cuda(Xs[i : i + 700].contiguous(), Xs, M, 1.0, 0.2, i, kernel_type="rbf")
        for i in range(0, n, 700)
    ]
    torch.testing.assert_close(torch.cat(parts), full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(full, kernel_matmul_plain(Xs, Xs, M, 1.0, 0.2, kernel_type="rbf"), **TOL)


@pytest.mark.cuda
def test_matern12_duplicated_rows_give_the_plain_diagonal(cuda_device):
    """Coincident points must give d2 = 0 exactly: Matérn-½ would move by
    ~sqrt(d2) (3e-4 for a d2 of 1e-7 left by cancellation) otherwise.  A
    one-hot M reads the diagonal out; what is left is f32 rounding of the
    3xTF32 split (rtol 1e-6)."""
    rng = np.random.default_rng(12)
    X = rng.standard_normal((300, 8)).astype(np.float32) * 3.0
    X = np.concatenate([X, X[:100]])  # rows 300.. repeat rows 0..99
    Xs = torch.from_numpy(X).to(cuda_device)
    n = len(X)
    M = torch.zeros((n, 16), device=cuda_device)
    ar = torch.arange(16, device=cuda_device)
    cols = 6 * ar
    M[cols, ar] = 1.0
    out = km.kernel_matmul_cuda(Xs, Xs, M, 1.1, 0.1, kernel_type="matern12")
    plain = kernel_matmul_plain(Xs, Xs, M, 1.1, 0.1, kernel_type="matern12")
    torch.cuda.synchronize()
    torch.testing.assert_close(out[cols, ar], plain[cols, ar], rtol=1e-6, atol=0.0)
    dup = cols + 300  # the copies of those rows: K(x, x) without the sigma2
    torch.testing.assert_close(out[dup, ar], plain[dup, ar], rtol=1e-6, atol=0.0)
    torch.testing.assert_close(out, plain, **TOL)


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    Xs, M = _inputs(2, 64, 3, (64, 4), cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        km.kernel_matmul_cuda(Xs, Xs, M.T.contiguous().T, 1.0, 0.0)
    with pytest.raises(TypeError, match="float32"):
        km.kernel_matmul_cuda(Xs, Xs, M.double(), 1.0, 0.0)
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        km.kernel_matmul_cuda(Xs, Xs.cpu(), M, 1.0, 0.0)


def _state(seed, b, n, t, dev):
    g = torch.Generator().manual_seed(seed)
    state = [torch.randn((b, n, t), generator=g).to(dev) for _ in range(4)]
    alpha = torch.randn((b, t), generator=g).to(dev)
    beta = 0.5 * torch.randn((b, t), generator=g).to(dev)
    return state, [alpha, beta, torch.ones_like(alpha)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 8, 9, 16, 17, 33, 64])
def test_fused_step_matches_plain(cuda_device, kernel_type, t, b):
    """Every column-block width of B3's product (16, 32, 64), ragged and
    full, batched, at an odd n."""
    n = 1001
    Xs, _ = _inputs(t + b, n, 8, (1,), cuda_device)
    state, scalars = _state(t, b, n, t, cuda_device)
    scalars[0][:, 0] = scalars[1][:, 0] = scalars[2][:, 0] = 0.0  # a frozen column
    before = km.fused_launches
    out = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.1,
                                kernel_type=kernel_type)
    torch.cuda.synchronize()
    assert km.fused_launches == before + 1
    ref = fused_cg_step_plain(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.1,
                              kernel_type=kernel_type)
    for a, r in zip(out[:4], ref[:4]):
        torch.testing.assert_close(a, r, **TOL)
    torch.testing.assert_close(out[4], ref[4], **RED_TOL)
    assert torch.equal(out[0][..., 0], state[0][..., 0])
    assert torch.equal(out[1][..., 0], state[1][..., 0])
    # the outputs are new tensors: the inputs were not written
    assert all(a.data_ptr() != s.data_ptr() for a, s in zip(out[:4], state))


@pytest.mark.cuda
def test_fused_step_shards_reassemble(cuda_device):
    n, t = 3001, 9
    Xs, _ = _inputs(3, n, 5, (1,), cuda_device)
    state, scalars = _state(4, 2, n, t, cuda_device)
    full = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.0, 0.3,
                                 kernel_type="matern32")
    parts = [
        km.fused_cg_step_cuda(Xs[i : i + 1000].contiguous(), Xs,
                              *[s[:, i : i + 1000].contiguous() for s in state],
                              *state[1:], *scalars, 1.0, 0.3, i, kernel_type="matern32")
        for i in range(0, n, 1000)
    ]
    for k in range(4):
        torch.testing.assert_close(torch.cat([p[k] for p in parts], dim=1), full[k],
                                   rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(p[4] for p in parts), full[4], **RED_TOL)


@pytest.mark.cuda
def test_fused_step_zero_columns_give_exactly_zero(cuda_device):
    """Padded probe columns (all-zero state, α = β = γ = 0) give exactly 0
    in every output and reduction, and a frozen column keeps U and R."""
    n, t, b = 1537, 9, 2
    Xs, _ = _inputs(5, n, 8, (1,), cuda_device)
    state, scalars = _state(6, b, n, t, cuda_device)
    for x in scalars:
        x[:, 3:5] = 0.0
    for x in state:
        x[:, :, 4] = 0.0
    out = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.0, 0.1,
                                kernel_type="matern52")
    torch.cuda.synchronize()
    assert all(bool((x[..., 4] == 0).all()) for x in out)
    assert torch.equal(out[0][..., 3], state[0][..., 3])
    assert torch.equal(out[1][..., 3], state[1][..., 3])
    ref = fused_cg_step_plain(Xs, Xs, *state, *state[1:], *scalars, 1.0, 0.1,
                              kernel_type="matern52")
    for a, r in zip(out[:4], ref[:4]):
        torch.testing.assert_close(a, r, **TOL)
    torch.testing.assert_close(out[4], ref[4], **RED_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("separate_columns", [False, True])
def test_fused_step_is_bit_identical_across_runs(cuda_device, separate_columns):
    """No atomics: two runs on the same inputs give the same bits, and a
    column state held in other buffers (D′ of the columns formed in
    scratch) gives the same bits as the rows' own."""
    n, t = 4097, 9
    Xs, _ = _inputs(8, n, 8, (1,), cuda_device)
    state, scalars = _state(9, 3, n, t, cuda_device)
    cols = [x.clone() for x in state[1:]] if separate_columns else state[1:]
    runs = [km.fused_cg_step_cuda(Xs, Xs, *state, *cols, *scalars, 1.1, 0.2,
                                  kernel_type="rbf") for _ in range(2)]
    shared = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.2,
                                   kernel_type="rbf")
    torch.cuda.synchronize()
    for a, b, c in zip(*runs, shared):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
@pytest.mark.parametrize("t", [1, 9, 33])
def test_grad_kernel_matches_plain(cuda_device, kernel_type, t):
    rows, cols = 1001, 1537
    X1, C = _inputs(t, rows, 8, (rows, t), cuda_device)
    X2, M = _inputs(t + 1, cols, 8, (cols, t), cuda_device)
    X2[9] = X1[4]  # coincident points: Matérn-½'s f′ is unbounded there
    before = km.grad_launches
    out = km.kernel_matmul_grad_cuda(X1, X2, M, C, 1.1, 0.1, 3, kernel_type=kernel_type)
    torch.cuda.synchronize()
    assert km.grad_launches == before + 2
    ref = kernel_matmul_grad_plain(X1, X2, M, C, 1.1, 0.1, 3, kernel_type=kernel_type)
    for a, r in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        err = float((a - r).abs().max())
        assert err <= 2e-4 * float(r.abs().max()), err


def _rel_close(a, r):
    assert bool(torch.isfinite(a).all())
    err = float((a - r).abs().max())
    assert err <= 2e-4 * float(r.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
@pytest.mark.parametrize("d", [1, 3, 8, 32])
@pytest.mark.parametrize("t", [1, 9, 33])
def test_grad_sym_matches_plain_and_two_launches(cuda_device, kernel_type, d, t):
    """One X on both sides: the one-launch symmetric VJP against its plain
    twin and against the two-launch path's ∂/∂X1 + ∂/∂X2, at 2e-4 of each
    gradient's largest entry."""
    n = 1001
    X, C = _inputs(d + t, n, d, (n, t), cuda_device)
    M = _inputs(d + t + 1, 1, 1, (n, t), cuda_device)[1]
    X[17] = X[2]  # coincident points off the diagonal
    before = km.grad_launches
    out = km.kernel_matmul_grad_sym_cuda(X, M, C, 1.1, 0.1, kernel_type=kernel_type)
    torch.cuda.synchronize()
    assert km.grad_launches == before + 1
    ref = kernel_matmul_grad_sym_plain(X, M, C, 1.1, 0.1, kernel_type=kernel_type)
    two = km.kernel_matmul_grad_cuda(X, X, M, C, 1.1, 0.1, kernel_type=kernel_type)
    for a, r in zip(out, ref):
        _rel_close(a, r)
    for a, r in zip(out, (two[0] + two[1], two[2], two[3])):
        _rel_close(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric", [True, False])
def test_grad_matern12_near_coincident_rows_match_f64(cuda_device, symmetric):
    """Matérn-½ with duplicated rows and rows 1e-3 apart (f′ ~ 1/r there):
    finite, and held to a float64 evaluation whose distances come from
    differences (exactly 0 at coincident points)."""
    n, t = 777, 9
    X, M = _inputs(31, n, 8, (n, t), cuda_device)
    C = _inputs(32, 1, 1, (n, t), cuda_device)[1]
    X[100] = X[7]
    X[200] = X[7] * (1 + 1e-3)
    X[300] = X[8] + 1e-3
    if symmetric:
        gX, gs, gs2 = km.kernel_matmul_grad_sym_cuda(X, M, C, 1.3, 0.2, kernel_type="matern12")
    else:
        g1, g2, gs, gs2 = km.kernel_matmul_grad_cuda(X, X, M, C, 1.3, 0.2,
                                                     kernel_type="matern12")
        gX = g1 + g2
    torch.cuda.synchronize()
    Xd = X.double().requires_grad_()
    s = torch.tensor(1.3, dtype=torch.float64, device=cuda_device, requires_grad=True)
    d2 = ((Xd[:, None, :] - Xd[None, :, :]) ** 2).sum(-1)
    K = s * torch.exp(-torch.sqrt(torch.clamp(d2, min=1e-20)))
    (K @ M.double()).backward(C.double())
    for a, r in ((gX, Xd.grad), (gs, s.grad), (gs2, (C.double() * M.double()).sum())):
        _rel_close(a.double(), r)


@pytest.mark.cuda
def test_fused_training_launches(cuda_device):
    """A fused fit: every forward CG iteration one B3 launch and no B1; the
    backward one gradient-kernel launch (the symmetric VJP) and B1 once,
    the VJP's primal."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings

    g = torch.Generator().manual_seed(0)
    X = (2 * torch.rand((2000, 8), generator=g) - 1).to(cuda_device)
    y = torch.sin(3 * X[:, 0])
    gp = ExactGP(kernel_type="matern52", mode="cuda", fuse_cg=True,
                 settings=BBMMSettings(num_probes=4, max_cg_iters=10, precond_rank=0))
    counts = []

    def on_step(i, loss):
        counts.append((km.fused_launches, km.launches, km.grad_launches))
        km.reset_launch_counts()

    km.reset_launch_counts()
    _, history = gp.fit(X, y, steps=2, callback=on_step)
    assert all(np.isfinite(history))
    assert counts == [(10, 1, 1), (10, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,offset", [(1501, 0), (600, 433)])
def test_batched_product_gradient_matches_plain(cuda_device, rows, offset):
    """B2 differentiable: its backward folds the batch into columns, one
    gradient-kernel launch (one X on both sides) or two (a row slice with
    its offset), against the sum over the batch of the plain 2-D VJPs."""
    from repro_torch.kernels.kernel_matmul.ops import fused_kernel_matmul_prescaled

    n, b, t = 1501, 4, 9
    Xs, M = _inputs(7, n, 8, (b, n, t), cuda_device)
    C = torch.from_numpy(np.random.default_rng(8).standard_normal((b, rows, t)).astype(
        np.float32)).to(cuda_device)
    Xg = Xs.clone().requires_grad_()
    s = torch.tensor(1.2, device=cuda_device, requires_grad=True)
    s2 = torch.tensor(0.1, device=cuda_device, requires_grad=True)
    Xr = Xg if rows == n else Xg[offset : offset + rows]
    km.reset_launch_counts()
    out = fused_kernel_matmul_prescaled(Xr, Xg, M, s, s2, offset, kernel_type="matern52")
    got = torch.autograd.grad(out, (Xg, s, s2), C)
    torch.cuda.synchronize()
    assert (km.batched_launches, km.launches) == (1, 0)
    assert km.grad_launches == (1 if rows == n else 2)
    want = [torch.zeros_like(Xs), 0.0, 0.0]
    for i in range(b):
        g1, g2, gs, gs2 = kernel_matmul_grad_plain(Xs[offset : offset + rows], Xs, M[i], C[i],
                                                   1.2, 0.1, offset, kernel_type="matern52")
        want[0][offset : offset + rows] += g1
        want[0] += g2
        want[1] += gs
        want[2] += gs2
    assert _rel(got[0], want[0]) <= 2e-4
    for g, w in zip(got[1:], want[1:]):
        assert abs(float(g) - float(w)) <= 2e-4 * abs(float(w))


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape_m", [(5003, 9), (3, 5003, 9)])
def test_streamed_matmul_matches_full_range(cuda_device, shape_m, compute_dtype):
    """K·M streamed one row panel at a time (a height that is a multiple of
    64 and one that is not, the last panel shorter) against B1/B2's one
    full-range launch: the same bits where the panels start on 64-row
    blocks, 1e-4 otherwise; one launch per panel, each counted as a panel
    launch."""
    from repro_torch.kernels.kernel_matmul.ops import panel_matmul_prescaled

    n = shape_m[-2]
    Xs, M = _inputs(9, n, 4, shape_m, cuda_device)
    full = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.0, kernel_type="rbf",
                                 compute_dtype=compute_dtype)
    for p in (1024, 1000):
        km.reset_launch_counts()
        out = panel_matmul_prescaled(Xs, M, 1.0, p, kernel_type="rbf",
                                     compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        launched = (km.launches + km.batched_launches + km.bf16_launches
                    + km.bf16_batched_launches)
        assert launched == km.panel_launches == -(-n // p)
        if p % 64 == 0:
            assert torch.equal(out, full)
        torch.testing.assert_close(out, full, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 3])
def test_panel_fused_step_matches_full_range(cuda_device, b, compute_dtype):
    """One CG iteration streamed by row panels (B3 once per panel on its
    rows with its row offset, the full pre-update state as the column
    side, a last panel that does not divide) against B3's one full-range
    launch: the state at rtol / atol 2e-4 (the bits, where panels start on
    64-row blocks), the reductions folded in panel order at 2e-3."""
    from repro_torch.kernels.kernel_matmul.ops import panel_fused_cg_step_prescaled

    n, t = 4099, 9
    rng = np.random.default_rng(b)
    Xs, _ = _inputs(11, n, 4, (1,), cuda_device)
    state = [torch.from_numpy(rng.standard_normal((b, n, t)).astype(np.float32)).to(cuda_device)
             for _ in range(4)]
    scal = [torch.from_numpy(rng.uniform(0.1, 1.0, (b, t)).astype(np.float32)).to(cuda_device)
            for _ in range(3)]
    full = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scal, 1.0, 0.5,
                                 kernel_type="rbf", compute_dtype=compute_dtype)
    for p in (1024, 1000):
        km.reset_launch_counts()
        out = panel_fused_cg_step_prescaled(Xs, *state, *scal, 1.0, 0.5, panel_rows=p,
                                            kernel_type="rbf", compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        assert km.fused_launches + km.bf16_fused_launches == km.panel_launches == -(-n // p)
        for a, w in zip(out[:4], full[:4]):
            if p % 64 == 0:
                assert torch.equal(a, w)
            torch.testing.assert_close(a, w, **TOL)
        red = torch.stack(out[4], dim=-2)
        torch.testing.assert_close(red, full[4], rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_m", [(3001, 9), (4, 3001, 9)])
def test_panel_vjp_matches_symmetric_vjp(cuda_device, shape_m):
    """The partitioned backward — one gradient-kernel launch per row panel
    with the symmetric weight — against the one-launch symmetric VJP of
    the same product (a batched M folded into columns), rtol 2e-3 / atol
    1e-4 (tests/test_partitioned.py's gradient tolerance)."""
    from repro_torch.kernels.kernel_matmul.kernel_matmul import _fold_batch
    from repro_torch.kernels.kernel_matmul.ops import panel_vjp_prescaled

    n = shape_m[-2]
    Xs, M = _inputs(13, n, 4, shape_m, cuda_device)
    C = torch.from_numpy(np.random.default_rng(14).standard_normal(shape_m).astype(
        np.float32)).to(cuda_device)
    km.reset_launch_counts()
    gX, gs = panel_vjp_prescaled(Xs, M, C, 1.3, 1000, kernel_type="rbf")
    torch.cuda.synchronize()
    assert km.grad_launches == 4
    wX, ws, _ = km.kernel_matmul_grad_sym_cuda(Xs, _fold_batch(M), _fold_batch(C), 1.3, 0.0,
                                               kernel_type="rbf")
    torch.testing.assert_close(gX, wX, rtol=2e-3, atol=1e-4)
    assert abs(float(gs) - float(ws)) <= 2e-3 * abs(float(ws))


@pytest.mark.cuda
def test_multi_output_and_partitioned_gp_launches(cuda_device):
    """A multi-output MLL (y (4, n)) runs B2 in every CG iteration and one
    gradient launch in its backward; a cuda_partitioned fused MLL runs B3
    once per panel per iteration and its backward one gradient launch per
    panel."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings

    g = torch.Generator().manual_seed(0)
    n = 3000
    X = (2 * torch.rand((n, 4), generator=g) - 1).to(cuda_device)
    Y = torch.stack([torch.sin(3 * X[:, 0] + k) for k in range(4)])
    p = 6
    gp = ExactGP(kernel_type="matern52", mode="cuda",
                 settings=BBMMSettings(num_probes=4, max_cg_iters=p, precond_rank=5))
    params = {k: v.requires_grad_() for k, v in gp.init_params(X).items()}
    km.reset_launch_counts()
    loss = gp.loss(params, X, Y, torch.Generator(device=cuda_device).manual_seed(0))
    assert loss.shape == (4,) and (km.batched_launches, km.launches) == (p, 0)
    km.reset_launch_counts()
    loss.sum().backward()
    torch.cuda.synchronize()
    assert (km.batched_launches, km.grad_launches) == (1, 1)  # the VJP's primal, one VJP
    part = ExactGP(kernel_type="rbf", mode="cuda_partitioned", fuse_cg=True,
                   settings=BBMMSettings(num_probes=4, max_cg_iters=p, precond_rank=0,
                                         panel_rows=1024))
    params = {k: v.detach().requires_grad_() for k, v in part.init_params(X).items()}
    km.reset_launch_counts()
    loss = part.loss(params, X, Y[0], torch.Generator(device=cuda_device).manual_seed(0))
    assert (km.fused_launches, km.panel_launches) == (3 * p, 3 * p)
    km.reset_launch_counts()
    loss.backward()
    torch.cuda.synchronize()
    assert km.grad_launches == 3 and km.launches == km.panel_launches == 3
    assert all(bool(torch.isfinite(v.grad).all()) for v in params.values())


# bf16 B1/B2/B3 against their bf16 plain versions: both round the same f32
# kernel entries and right-hand side to bf16 and sum in f32; they part only
# where an entry's f32 value straddles a bf16 rounding boundary (the kernel's
# exp and the plain version's round differently), which moves that one term
# by 2^-8 of itself — so 2e-3 of the largest output, and 2e-2 of the f32
# product (the reference's bf16 tolerance, tests/test_precision.py:89)
BF16_REL = 2e-3
F32_REL = 2e-2


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _bf16_counts():
    return (km.bf16_launches, km.bf16_batched_launches, km.bf16_fused_launches,
            km.launches, km.batched_launches, km.fused_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
@pytest.mark.parametrize("d", [1, 3, 8, 17])
@pytest.mark.parametrize("t,batch", [(1, 0), (9, 0), (17, 0), (234, 0), (256, 0), (512, 0), (9, 4)])
def test_bf16_kernel_matches_plain(cuda_device, kernel_type, d, t, batch):
    """bf16 B1 (2-D M) and B2 (b = 4): every column block, odd n, ARD."""
    n = 1001
    shape = (batch, n, t) if batch else (n, t)
    Xs, M = _inputs(n + t + d, n, d, shape, cuda_device)
    Xs = Xs.to(torch.bfloat16).float()  # prescaled under the mixed policy
    km.reset_launch_counts()
    out = km.kernel_matmul_cuda(Xs, Xs, M, 1.1, 0.1, kernel_type=kernel_type,
                                compute_dtype="bfloat16")
    torch.cuda.synchronize()
    assert _bf16_counts() == ((0, 1, 0, 0, 0, 0) if batch else (1, 0, 0, 0, 0, 0))
    plain = kernel_matmul_plain(Xs, Xs, M, 1.1, 0.1, kernel_type=kernel_type,
                                compute_dtype="bfloat16")
    f32 = kernel_matmul_plain(Xs, Xs, M, 1.1, 0.1, kernel_type=kernel_type)
    assert bool(torch.isfinite(out).all())
    assert _rel(out, plain) <= BF16_REL
    assert _rel(out, f32) <= F32_REL


@pytest.mark.cuda
@pytest.mark.parametrize("t", [9, 256])
def test_bf16_kernel_row_offset_slices_reassemble(cuda_device, t):
    n = 4097
    Xs, M = _inputs(11, n, 8, (n, t), cuda_device)
    Xs = Xs.to(torch.bfloat16).float()
    full = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.2, kernel_type="matern52", compute_dtype="mixed")
    for off, rows in ((0, 1024), (1500, 1024), (3000, 1097)):
        part = km.kernel_matmul_cuda(Xs[off : off + rows].contiguous(), Xs, M, 1.0, 0.2, off,
                                     kernel_type="matern52", compute_dtype="mixed")
        plain = kernel_matmul_plain(Xs[off : off + rows], Xs, M, 1.0, 0.2, off,
                                    kernel_type="matern52", compute_dtype="mixed")
        torch.testing.assert_close(part, full[off : off + rows], rtol=0, atol=0)
        assert _rel(part, plain) <= BF16_REL


@pytest.mark.cuda
def test_bf16_kernel_matern12_coincident_points_are_exact(cuda_device):
    """The distance stays one f32 fmaf chain: duplicated rows give k(0) = 1
    exactly, which bf16 holds exactly, as the plain version does."""
    n = 777
    Xs, _ = _inputs(12, n, 8, (1,), cuda_device)
    Xs = Xs.to(torch.bfloat16).float()
    Xs[100] = Xs[7]
    E = torch.zeros((n, 16), device=cuda_device)
    E[7, 0] = E[100, 1] = 1.0
    out = km.kernel_matmul_cuda(Xs, Xs, E, 1.0, 0.0, kernel_type="matern12", compute_dtype="mixed")
    assert float(out[100, 0]) == 1.0 and float(out[7, 1]) == 1.0 and float(out[7, 0]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel_type", KERNEL_TYPES)
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 9, 16, 17, 33, 64])
def test_bf16_fused_step_matches_plain(cuda_device, kernel_type, t, b):
    """bf16 B3: the f32 state at the f32 step's tolerance, V′ and each of the
    four reductions at 2e-3 of its largest; a frozen column keeps U and R."""
    n = 1001
    Xs, _ = _inputs(t + b + 1, n, 8, (1,), cuda_device)
    Xs = Xs.to(torch.bfloat16).float()
    state, scalars = _state(t + 1, b, n, t, cuda_device)
    scalars[0][:, 0] = scalars[1][:, 0] = scalars[2][:, 0] = 0.0
    km.reset_launch_counts()
    out = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.1,
                                kernel_type=kernel_type, compute_dtype="bfloat16")
    torch.cuda.synchronize()
    assert _bf16_counts() == (0, 0, 1, 0, 0, 0)
    ref = fused_cg_step_plain(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.1,
                              kernel_type=kernel_type, compute_dtype="bfloat16")
    for a, r in zip(out[:3], ref[:3]):
        torch.testing.assert_close(a, r, **TOL)
    assert _rel(out[3], ref[3]) <= BF16_REL
    for k in range(4):
        assert _rel(out[4][:, k], ref[4][:, k]) <= BF16_REL, k
    assert torch.equal(out[0][..., 0], state[0][..., 0])
    assert torch.equal(out[1][..., 0], state[1][..., 0])
    f32 = fused_cg_step_plain(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.1, kernel_type=kernel_type)
    assert _rel(out[3], f32[3]) <= F32_REL


@pytest.mark.cuda
def test_bf16_fused_step_shards_columns_and_runs_agree(cuda_device):
    """Row shards reassemble the full step bit for bit, a separate column
    state (D′ rounded from the columns' own state) gives the same bits as
    the shared one, and two runs give the same bits: no atomics."""
    n, t = 3001, 9
    Xs, _ = _inputs(13, n, 8, (1,), cuda_device)
    Xs = Xs.to(torch.bfloat16).float()
    state, scalars = _state(14, 2, n, t, cuda_device)
    run = lambda cols: km.fused_cg_step_cuda(Xs, Xs, *state, *cols, *scalars, 1.0, 0.3,  # noqa: E731
                                             kernel_type="matern32", compute_dtype="mixed")
    full, again, sep = run(state[1:]), run(state[1:]), run([x.clone() for x in state[1:]])
    parts = [
        km.fused_cg_step_cuda(Xs[i : i + 1000].contiguous(), Xs,
                              *[s[:, i : i + 1000].contiguous() for s in state],
                              *state[1:], *scalars, 1.0, 0.3, i, kernel_type="matern32",
                              compute_dtype="mixed")
        for i in range(0, n, 1000)
    ]
    torch.cuda.synchronize()
    for k in range(4):
        assert torch.equal(torch.cat([p[k] for p in parts], dim=1), full[k])
    torch.testing.assert_close(sum(p[4] for p in parts), full[4], **RED_TOL)
    for a, b, c in zip(full, again, sep):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_mixed_training_and_serving_launches(cuda_device):
    """precision="mixed" on the card: every loop iteration one bf16 launch
    (B3 fused, B1 unfused), every refresh one f32 B1 launch (the static
    period 2: ⌊p/2⌋ in the loop and one final), the backward one f32 B1 (the
    VJP's primal) and one gradient launch; the cache build's Gram product
    f32.  Nothing falls back to f32 in the loop."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings

    g = torch.Generator().manual_seed(0)
    X = (2 * torch.rand((2000, 8), generator=g) - 1).to(cuda_device)
    y = torch.sin(3 * X[:, 0])
    p = 10
    refresh = p // 2 + 1
    gp = ExactGP(kernel_type="matern52", mode="cuda", fuse_cg=True, precision="mixed",
                 settings=BBMMSettings(num_probes=4, max_cg_iters=p, precond_rank=0))
    counts = []

    def on_step(i, loss):
        counts.append((km.bf16_fused_launches, km.fused_launches, km.bf16_launches,
                       km.launches, km.grad_launches))
        km.reset_launch_counts()

    km.reset_launch_counts()
    params, history = gp.fit(X, y, steps=2, callback=on_step)
    assert all(np.isfinite(history))
    assert counts == [(p, 0, 0, refresh + 1, 1)] * 2
    serve = ExactGP(kernel_type="matern52", mode="cuda", precision="mixed",
                    settings=BBMMSettings(num_probes=4, max_cg_iters=p, precond_rank=5))
    km.reset_launch_counts()
    cache = serve.posterior_cache(params, X, y)
    assert (km.bf16_launches, km.launches, km.fused_launches) == (p, refresh + 1, 0)
    km.reset_launch_counts()
    mean, var = serve.predict_cached(params, X, cache, X[:64])
    assert (km.bf16_launches, km.launches) == (0, 0)
    assert bool(torch.isfinite(mean).all() & (var > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,dh,causal",
    [(2, 4, 4, 128, 128, 64, True), (2, 4, 4, 256, 384, 32, False), (1, 8, 2, 128, 128, 32, True),
     (1, 2, 2, 200, 200, 112, True), (1, 2, 2, 77, 300, 224, False), (2, 4, 4, 130, 130, 224, True)],
)
def test_flash_attention_matches_plain(cuda_device, dtype, b, hq, hkv, sq, skv, dh, causal):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain

    g = torch.Generator().manual_seed(sq + skv + dh)
    q = torch.randn((b, hq, sq, dh), generator=g).to(cuda_device, dtype)
    k = torch.randn((b, hkv, skv, dh), generator=g).to(cuda_device, dtype)
    v = torch.randn((b, hkv, skv, dh), generator=g).to(cuda_device, dtype)
    before = fa.launches
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1 and out.dtype == dtype
    ref = gqa_attention_plain(q, k, v, causal=causal)
    tol = TOL if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [32, 64, 96, 112, 128, 224, 256])
def test_flash_attention_bf16_head_dims(cuda_device, dh, causal):
    """The bf16 tensor-core path at every head dim it takes (multiples of
    16 up to 256), GQA 8 / 2, in the model's strided (b, s, h, dh) views."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain

    g = torch.Generator().manual_seed(dh + causal)
    q = torch.randn((2, 200, 8, dh), generator=g).to(cuda_device, torch.bfloat16).transpose(1, 2)
    k = torch.randn((2, 200, 2, dh), generator=g).to(cuda_device, torch.bfloat16).transpose(1, 2)
    v = torch.randn((2, 200, 2, dh), generator=g).to(cuda_device, torch.bfloat16).transpose(1, 2)
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = gqa_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(1, 63), (63, 65), (65, 1), (511, 63), (65, 511), (1, 1)])
def test_flash_attention_bf16_ragged(cuda_device, sq, skv, causal):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain

    g = torch.Generator().manual_seed(sq * 1000 + skv)
    q = torch.randn((2, 4, sq, 224), generator=g).to(cuda_device, torch.bfloat16)
    k = torch.randn((2, 2, skv, 224), generator=g).to(cuda_device, torch.bfloat16)
    v = torch.randn((2, 2, skv, 224), generator=g).to(cuda_device, torch.bfloat16)
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = gqa_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_unaligned_strides(cuda_device, dtype):
    """Rows that are not 16-byte aligned (a 1-element offset into a wider
    buffer) and a head dim that is not a multiple of 16 take the CUDA-core
    path: same results, same tolerances."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain

    g = torch.Generator().manual_seed(5)
    for dh, width in ((64, 67), (40, 40)):
        buf = torch.randn((3, 2, 130, 4, width), generator=g).to(cuda_device, dtype)
        q, k, v = (buf[i, :, :, :, 1 : 1 + dh].transpose(1, 2) if width > dh
                   else buf[i].transpose(1, 2) for i in range(3))
        out = fa.flash_attention_cuda(q, k, v, causal=True)
        torch.cuda.synchronize()
        ref = gqa_attention_plain(q, k, v, causal=True)
        tol = TOL if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
        torch.testing.assert_close(out.float(), ref.float(), **tol)


def _ssd_inputs(seed, b, h, l, dh, ds, dev, dtype):
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, h, l, dh), generator=g).to(dev, dtype)
    dt = F.softplus(torch.randn((b, h, l), generator=g) - 1.0).to(dev)
    A = (-F.softplus(torch.randn((h,), generator=g))).to(dev)
    B = torch.randn((b, l, ds), generator=g).to(dev, dtype)
    C = torch.randn((b, l, ds), generator=g).to(dev, dtype)
    return x, dt, A, B, C


def _ssd_model_views(seed, b, h, l, dh, ds, dev):
    """x, B and C as the Mamba-2 block hands them over: slices of one
    (b, l, h·dh + 2·ds) bf16 conv output, x viewed (b, h, l, dh); dt the
    (b, l, h) projection transposed."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(seed)
    di = h * dh
    xBC = torch.randn((b, l, di + 2 * ds), generator=g).to(dev, torch.bfloat16)
    x = xBC[..., :di].reshape(b, l, h, dh).transpose(1, 2)
    dt = F.softplus(torch.randn((b, l, h), generator=g) - 1.0).to(dev).transpose(1, 2)
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    return x, dt, A, xBC[..., di : di + ds], xBC[..., di + ds :]


SSD_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3), torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "cuda cores"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [32, 64, 128])
@pytest.mark.parametrize("b,h,l,dh,ds", [(2, 3, 256, 16, 8), (1, 2, 128, 64, 64), (2, 4, 384, 64, 64)])
def test_ssd_scan_matches_plain(cuda_device, dtype, chunk, b, h, l, dh, ds, route):
    """Both routes (the default, which sends aligned bf16 with dh, ds
    multiples of 16 to the tensor cores, and the CUDA-core kernel forced)
    against the plain chunked version and the recurrence."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref, ssd_scan_ref

    x, dt, A, B, C = _ssd_inputs(l + chunk + dh, b, h, l, dh, ds, cuda_device, dtype)
    before = ssd.launches
    out = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, _cuda_cores=route == "cuda cores")
    torch.cuda.synchronize()
    assert ssd.launches == before + 1 and out.dtype == dtype
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(out.float(), ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk).float(), **tol)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ssd_scan_ref(x, dt, A, B, C), **tol)
    else:
        torch.testing.assert_close(out.float(), ssd_scan_ref(*(t.double() for t in (x, dt, A, B, C))).float(), **tol)


def _f64_distances(out, x, dt, A, B, C, chunk):
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref, ssd_scan_ref

    exact = ssd_scan_ref(*(t.double() for t in (x, dt, A, B, C)))
    plain = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk)
    return (float((out.double() - exact).abs().max()), float((plain.double() - exact).abs().max()),
            plain)


@pytest.mark.cuda
def test_ssd_scan_slice_on_the_model_views(cuda_device):
    """The serving slice (b = 4, 112 heads, l = 512, dh = ds = 64, chunk
    128) on the model's strided bf16 views takes the tensor cores, meets
    5e-2 against the plain version and lies no further than 2 × the plain
    version's distance from the f64 recurrence."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    args = _ssd_model_views(11, 4, 112, 512, 64, 64, cuda_device)
    assert ssd.b5_route(*args, 128) == "tensor cores"
    out = ssd.ssd_scan_cuda(*args, chunk=128)
    torch.cuda.synchronize()
    ours, plain_err, plain = _f64_distances(out, *args, 128)
    torch.testing.assert_close(out.float(), plain.float(), **SSD_TOL[torch.bfloat16])
    assert ours <= 2 * plain_err, (ours, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "cuda cores"])
def test_ssd_scan_long_sequence_carries_the_state(cuda_device, route):
    """l = 4,096: 32 chunks carry the state, in bf16 on both routes."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    args = _ssd_inputs(12, 1, 4, 4096, 64, 64, cuda_device, torch.bfloat16)
    assert ssd.b5_route(*args, 128) == "tensor cores"
    out = ssd.ssd_scan_cuda(*args, chunk=128, _cuda_cores=route == "cuda cores")
    torch.cuda.synchronize()
    ours, plain_err, plain = _f64_distances(out, *args, 128)
    torch.testing.assert_close(out.float(), plain.float(), **SSD_TOL[torch.bfloat16])
    assert ours <= 2 * plain_err, (ours, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("dh,ds", [(128, 64), (64, 128), (128, 128), (32, 16), (48, 80)])
def test_ssd_scan_head_and_state_widths_on_the_tensor_cores(cuda_device, dh, ds):
    """Every head and state width the tensor-core route takes (multiples
    of 16 up to 128; both of its builds) against the plain version, the
    recurrence and the CUDA-core kernel on the same bf16 inputs."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref

    args = _ssd_inputs(15 + dh + ds, 2, 3, 256, dh, ds, cuda_device, torch.bfloat16)
    assert ssd.b5_route(*args, 64) == "tensor cores"
    out = ssd.ssd_scan_cuda(*args, chunk=64)
    cuda_cores = ssd.ssd_scan_cuda(*args, chunk=64, _cuda_cores=True)
    torch.cuda.synchronize()
    ours, plain_err, plain = _f64_distances(out, *args, 64)
    torch.testing.assert_close(out.float(), plain.float(), **SSD_TOL[torch.bfloat16])
    torch.testing.assert_close(out.float(), cuda_cores.float(), **SSD_TOL[torch.bfloat16])
    assert ours <= 2 * plain_err, (ours, plain_err)


@pytest.mark.cuda
def test_ssd_scan_unaligned_view_takes_the_cuda_cores(cuda_device):
    """x, B and C one element into a wider buffer (rows not 16-byte
    aligned): the route is the CUDA-core kernel — the same bits as that
    kernel forced — while the aligned copy takes the tensor cores (other
    bits); both meet the tolerance."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref

    x, dt, A, B, C = _ssd_inputs(13, 2, 3, 256, 64, 64, cuda_device, torch.bfloat16)
    wide = torch.zeros((2, 3, 256, 65), device=cuda_device, dtype=torch.bfloat16)
    wide[..., 1:] = x
    xu = wide[..., 1:]
    BC = torch.zeros((2, 256, 129), device=cuda_device, dtype=torch.bfloat16)
    BC[..., 1:65], BC[..., 65:] = B, C
    Bu, Cu = BC[..., 1:65], BC[..., 65:]
    assert ssd.b5_route(xu, dt, A, Bu, Cu, 64) == "cuda cores"
    assert ssd.b5_route(x, dt, A, B, C, 64) == "tensor cores"
    out = ssd.ssd_scan_cuda(xu, dt, A, Bu, Cu, chunk=64)
    forced = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=64, _cuda_cores=True)
    tc = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(out, forced)
    assert not torch.equal(tc, forced)
    plain = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=64).float()
    for y in (out, tc):
        torch.testing.assert_close(y.float(), plain, **SSD_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["default", "cuda cores"])
def test_ssd_scan_is_bit_identical_across_runs(cuda_device, route):
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    args = _ssd_model_views(14, 2, 16, 512, 64, 64, cuda_device)
    first = ssd.ssd_scan_cuda(*args, chunk=128, _cuda_cores=route == "cuda cores")
    second = ssd.ssd_scan_cuda(*args, chunk=128, _cuda_cores=route == "cuda cores")
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_hybrid_forward_runs_the_kernels(cuda_device):
    """The reduced zamba2 forward on the card: B5 once per Mamba-2 block, B4
    once per shared-attention invocation, and the same logits as the plain
    paths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.models import hybrid

    cfg = get_config("zamba2-7b").reduced()
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = hybrid.init(cfg, gen)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=cuda_device)
    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    out = hybrid.forward(params, cfg, tok)
    torch.cuda.synchronize()
    assert (ssd.launches, fa.launches) == (7, 2)
    plain = hybrid.forward(params, cfg, tok, use_kernels=False)
    assert (ssd.launches, fa.launches) == (7, 2)
    torch.testing.assert_close(out, plain, rtol=1e-3, atol=1e-3)


# --- health and streaming serving on the card -------------------------------


def _rbf_system(dev, n=1024, d=3, noise=0.5, seed=0):
    """A small RBF exact-GP system on the card, easy for CG (σ² = 0.5)."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings

    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype(np.float32)).to(dev)
    y = torch.sin(3 * X[:, 0]).contiguous()
    gp = ExactGP(mode="cuda", kernel_type="rbf", device=dev,
                 settings=BBMMSettings(num_probes=4, max_cg_iters=60, precond_rank=0))
    params = gp.init_params(X)
    params["raw_noise"] = torch.full((), float(np.log(np.expm1(noise))), device=dev)
    return gp, params, X, y


@pytest.mark.cuda
def test_fault_seam_corrupts_the_kernels_own_outputs(cuda_device):
    """FaultInjectingOperator on B1 and B3: every call still launches the
    kernel; a scheduled call's output gets NaN in the scheduled row band
    (and, for B3, in every reduction), any other call is the kernel's
    output bit for bit."""
    from repro_torch.core import AddedDiagOperator, FaultInjectingOperator, FaultSchedule

    gp, params, X, _ = _rbf_system(cuda_device)
    clean = gp.operator(params, X).prepare()
    sched = FaultSchedule(0, nan_calls=(1, 3), panel=(64, 8))
    op = AddedDiagOperator(FaultInjectingOperator(clean.base, schedule=sched),
                           clean.sigma2).prepare()
    M = torch.randn(X.shape[0], 9, device=cuda_device)
    km.reset_launch_counts()
    first, second = op.matmul(M), op.matmul(M)
    torch.cuda.synchronize()
    assert km.launches == 2
    want = clean.matmul(M)
    assert torch.equal(first, want)
    bad = torch.nonzero(~torch.isfinite(second))[:, 0].unique().tolist()
    assert bad == list(range(64, 72))
    step, clean_step = op.fused_cg_step_fn(), clean.fused_cg_step_fn()
    state = [torch.randn(X.shape[0], 9, device=cuda_device) for _ in range(4)]
    scal = [torch.full((9,), v, device=cuda_device) for v in (0.1, 0.2, 1.0)]
    km.reset_launch_counts()
    out2 = step(*state, *scal)  # call 2: clean
    out3 = step(*state, *scal)  # call 3: faulted
    torch.cuda.synchronize()
    assert km.fused_launches == 2
    ref = clean_step(*state, *scal)
    assert all(torch.equal(a, b) for a, b in zip(out2[:4], ref[:4]))
    assert all(torch.equal(a, b) for a, b in zip(out3[:3], ref[:3]))
    assert torch.nonzero(~torch.isfinite(out3[3]))[:, 0].unique().tolist() == list(range(64, 72))
    assert all(bool(torch.isnan(r).all()) for r in out3[4])
    assert sched.injected == [(1, FaultSchedule.NAN), (3, FaultSchedule.NAN)]


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["precision_f32", "unfused", "extend_budget", "dense_cholesky",
                                  "dense_direct"])
def test_each_ladder_rung_heals_on_the_card(cuda_device, rung):
    """One heal per rung, the launches inside each rung (the trace's launch
    markers) by kernel and dtype."""
    import warnings

    from repro_torch import obs
    from repro_torch.core import BBMMSettings, FaultSchedule, collect, health, solve
    from repro_torch.launch.gp_serve import _inject_operator

    gp, params, X, y = _rbf_system(cuda_device)
    p, C, D = 60, health.CONVERGED, health.NON_FINITE
    base = dict(num_probes=4, max_cg_iters=p, precond_rank=0, on_failure="degrade")
    sched_kw, settings, expect = {
        "precision_f32": (dict(nan_rate=1.0, reduced_only=True),
                          dict(base, precision="mixed", fuse_cg=True),
                          [("initial", None, {"bf16_fused_launches": p, "launches": p // 2 + 1}),
                           ("precision_f32", C, {"fused_launches": p})]),
        "unfused": (dict(nan_calls=(2,)), dict(base, fuse_cg=True),
                    [("initial", D, {"fused_launches": p}), ("unfused", C, {"launches": p})]),
        "extend_budget": (dict(nan_calls=(1,)), base,
                          [("initial", D, {"launches": p}),
                           ("extend_budget", C, {"launches": 2 * p})]),
        "dense_cholesky": (dict(nan_rate=1.0), dict(base, max_cg_iters=4),
                           [("initial", D, {"launches": 4}), ("extend_budget", D, {"launches": 8}),
                            ("dense_cholesky", C, {"launches": 1})]),
        "dense_direct": (dict(), dict(base, dense_direct_max_n=2048),
                         [("dense_direct", C, {"launches": 1})]),
    }[rung]
    op = _inject_operator(gp.operator(params, X), FaultSchedule(0, **sched_kw))
    with warnings.catch_warnings(), collect() as reports, obs.trace() as col:
        warnings.simplefilter("ignore", health.SolveHealthWarning)
        x = solve(op, y, BBMMSettings(**settings))
        torch.cuda.synchronize()
    report = reports[-1]
    assert [(r.rung, r.status) for r in report.rungs][-1] == (expect[-1][0], C)
    marks = col.instants("launch")
    spans = [s for s in col.spans() if s["name"].startswith("rung:")]
    assert [s["name"][5:] for s in spans] == [r for r, _, _ in expect]
    for span, (name, status, launches), rec in zip(spans, expect, report.rungs):
        assert status is None or rec.status == status, (name, rec.status)
        counts = {}
        for m in marks:
            if span["ts"] <= m["ts"] <= span["ts"] + span["dur"]:
                counts[m["args"]["counter"]] = counts.get(m["args"]["counter"], 0) + 1
        assert counts == launches, (name, counts)
    K = gp.kernel(params)(X, X).double() + gp.noise(params).double() * torch.eye(
        X.shape[0], dtype=torch.float64, device=cuda_device)
    res = float((K @ x.double() - y.double()).norm() / y.double().norm())
    assert res < 1e-3  # tests/test_health.py:225


@pytest.mark.cuda
def test_session_append_on_the_card(cuda_device):
    """PosteriorSession.observe on the card: an append launches f32 B1 for
    the residual, once per CG iteration and once for the new columns; the
    served mean is the rebuild's within CG tolerance and the variance is
    conservative against the exact posterior (tests/test_serving.py)."""
    from repro_torch.core import BBMMSettings
    from repro_torch.serving import PosteriorSession

    gp, params, X, y = _rbf_system(cuda_device, n=2000)
    gp.settings = BBMMSettings(num_probes=4, max_cg_iters=60, cg_tol=1e-6)
    session = PosteriorSession(gp, params, X[:1900], y[:1900])
    km.reset_launch_counts()
    assert session.observe(X[1900:], y[1900:]) == "append"
    torch.cuda.synchronize()
    assert (km.launches, km.bf16_launches, km.fused_launches) == (60 + 2, 0, 0)
    Xs = torch.rand(64, 3, device=cuda_device) * 2 - 1
    mean, var = session.query(Xs)
    rebuilt = PosteriorSession(gp, params, X, y)
    torch.testing.assert_close(mean, rebuilt.query(Xs)[0], rtol=1e-4, atol=1e-4)
    kern, noise = gp.kernel(params), gp.noise(params).double()
    K = kern(X, X).double() + noise * torch.eye(X.shape[0], dtype=torch.float64,
                                                device=cuda_device)
    Kxs = kern(X, Xs).double()
    exact = kern.diag(Xs).double() - (Kxs * torch.linalg.solve(K, Kxs)).sum(0) + noise
    assert bool((var.double() >= exact - 1e-3).all())


@pytest.mark.cuda
def test_engine_qr_is_safe_under_threads(cuda_device):
    """The engine's QR (``inference._qr``, the cache builds' and appends')
    from four threads at once on the card: cuSOLVER's geqrf fails when two
    threads call it together, so the engine serialises it; every call
    succeeds and gives the single-threaded factor."""
    import threading

    from repro_torch.core import inference

    A = torch.randn(40_000, 234, device=cuda_device)
    want = inference._qr(A)
    errors, outs = [], []

    def work():
        for _ in range(10):
            try:
                outs.append(inference._qr(A))
            except Exception as e:  # noqa: BLE001 — counted below
                errors.append(repr(e))

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not errors and len(outs) == 40
    assert all(torch.equal(o, want) for o in outs)


# --- the multitask and low-rank models -------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2003, 10_000])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_kernel_at_the_multitask_width(cuda_device, n, compute_dtype):
    """B1 at t = T·(1 + probes) = 36 (T = 4, 8 probes), f32 and bf16, against
    its plain version."""
    Xs, M = _inputs(n + 36, n, 8, (n, 36), cuda_device)
    if compute_dtype == "bfloat16":
        Xs = Xs.to(torch.bfloat16).float()
    km.reset_launch_counts()
    out = km.kernel_matmul_cuda(Xs, Xs, M, 1.1, 0.0, kernel_type="rbf",
                                compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    plain = kernel_matmul_plain(Xs, Xs, M, 1.1, 0.0, kernel_type="rbf",
                                compute_dtype=compute_dtype)
    if compute_dtype == "float32":
        assert (km.launches, km.bf16_launches) == (1, 0)
        torch.testing.assert_close(out, plain, **TOL)
    else:
        assert (km.launches, km.bf16_launches) == (0, 1)
        assert _rel(out, plain) <= BF16_REL


def _multitask_problem(dev, n=1500, T=4):
    from repro_torch.gp import to_long_format

    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (n, 8)).astype(np.float32)
    Y = np.sin(3 * X[:, :1]) * np.cos(2 * X[:, 7:8]) * (1 + 0.3 * np.arange(T))
    Xl, yl = to_long_format(X, Y + 0.05 * rng.standard_normal((n, T)))
    return torch.from_numpy(Xl).to(dev), torch.from_numpy(yl).to(dev)


@pytest.mark.cuda
def test_multitask_mll_gradient_on_the_card_matches_dense(cuda_device):
    """MultitaskGP(mode="cuda"): every CG iteration one B1 launch at T·t
    columns, the backward one gradient-kernel launch; over a 5-iteration
    prefix the MLL and every gradient against mode="dense" with the same
    probes (MLL 1e-4, gradients rtol 2e-3 / atol 1e-4)."""
    from repro_torch import MultitaskGP
    from repro_torch.core import BBMMSettings

    Xl, yl = _multitask_problem(cuda_device)
    settings = BBMMSettings(num_probes=8, max_cg_iters=5, cg_tol=1e-12, precond_rank=0)
    out = {}
    for mode in ("dense", "cuda"):
        gp = MultitaskGP(num_tasks=4, mode=mode, settings=settings, device=cuda_device)
        params = {k: v.requires_grad_() for k, v in gp.init_params(Xl).items()}
        km.reset_launch_counts()
        loss = gp.loss(params, gp.prepare_inputs(Xl), yl,
                       torch.Generator(device=cuda_device).manual_seed(0))
        forward = (km.launches, km.grad_launches)
        loss.backward()
        torch.cuda.synchronize()
        out[mode] = (float(loss), {k: v.grad for k, v in params.items()}, forward,
                     (km.launches, km.grad_launches))
    assert out["dense"][2:] == ((0, 0), (0, 0))
    assert out["cuda"][2] == (5, 0)  # one B1 a CG iteration, 36 columns each
    assert out["cuda"][3] == (6, 1)  # + the backward's primal and ONE gradient launch
    assert abs(out["cuda"][0] - out["dense"][0]) <= 1e-4 * abs(out["dense"][0])
    for k, g in out["cuda"][1].items():
        torch.testing.assert_close(g, out["dense"][1][k], rtol=2e-3, atol=1e-4)


@pytest.mark.cuda
def test_low_rank_and_deep_models_launch_no_kernel(cuda_device):
    """SGPR and BLR (two plain contractions of the root) and DKL (a dense
    deep kernel) train and serve on the card without a kernel launch."""
    from repro_torch import SGPR, BayesianLinearRegression, DKLExactGP
    from repro_torch.core import BBMMSettings
    from repro_torch.serving import PosteriorSession

    g = torch.Generator().manual_seed(0)
    X = (2 * torch.rand((4000, 8), generator=g) - 1).to(cuda_device)
    y = torch.sin(3 * X[:, 0])
    km.reset_launch_counts()
    for gp in (SGPR(num_inducing=100, device=cuda_device),
               BayesianLinearRegression(device=cuda_device),
               DKLExactGP(settings=BBMMSettings(max_cg_iters=10), device=cuda_device)):
        params, hist = gp.fit(X, y, steps=2)
        assert all(np.isfinite(hist))
        session = PosteriorSession(gp, params, X, y)
        assert session.observe(X[:16] * 0.5, y[:16]) == "append"
        mean, var = session.query(X[:64])
        assert bool(torch.isfinite(mean).all() & (var > 0).all())
    torch.cuda.synchronize()
    assert all(v == 0 for v in km.launch_counts().values()), km.launch_counts()

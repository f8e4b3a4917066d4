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
@pytest.mark.parametrize("d", [1, 3, 8, 16, 17, 33])
@pytest.mark.parametrize("t,batch", [(1, 0), (9, 0), (17, 0), (234, 0), (256, 0), (512, 0), (9, 4)])
def test_bf16_kernel_matches_plain(cuda_device, kernel_type, d, t, batch):
    """bf16 B1 (2-D M) and B2 (b = 4): every column block, odd n, ARD; d past
    16 takes more than one tensor-core k-step."""
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
@pytest.mark.parametrize("d", [8, 33])
def test_bf16_kernel_matern12_coincident_points_are_exact(cuda_device, d):
    """The norms are the diagonals of the product that gives the inner
    products, so duplicated rows off the diagonal (in other row and column
    tiles, and, at d = 33, over three k-steps) give d² = 0 and k(0) = 1
    exactly, which bf16 holds exactly, as the plain version does."""
    n = 777
    Xs, _ = _inputs(12, n, d, (1,), cuda_device)
    Xs = Xs.to(torch.bfloat16).float()
    Xs[100] = Xs[7]
    Xs[700] = Xs[7]
    E = torch.zeros((n, 16), device=cuda_device)
    E[7, 0] = E[100, 1] = E[700, 2] = 1.0
    out = km.kernel_matmul_cuda(Xs, Xs, E, 1.0, 0.0, kernel_type="matern12", compute_dtype="mixed")
    for i in (7, 100, 700):
        assert [float(v) for v in out[i, :3]] == [1.0, 1.0, 1.0], i


@pytest.mark.cuda
@pytest.mark.parametrize("off", [0, 37, 100])
def test_bf16_kernel_diagonal_at_a_row_offset(cuda_device, off):
    """σ² lands on the global diagonal row_offset + i == j, also where a row
    tile straddles two column tiles (row_offset not a multiple of 64): the
    entries against identity columns are the plain version's, σ² and k(0)
    exact there."""
    n, rows = 300, 150
    Xs, _ = _inputs(13, n, 8, (1,), cuda_device)
    Xs = Xs.to(torch.bfloat16).float()
    X1 = Xs[off : off + rows].contiguous()
    eye = torch.eye(n, device=cuda_device)
    out = km.kernel_matmul_cuda(X1, Xs, eye, 0.75, 0.5, off, kernel_type="matern52",
                                compute_dtype="mixed")
    idx = torch.arange(rows, device=cuda_device)
    assert bool((out[idx, idx + off] == 1.25).all())
    plain = kernel_matmul_plain(X1, Xs, eye, 0.75, 0.5, off, kernel_type="matern52",
                                compute_dtype="mixed")
    assert _rel(out, plain) <= BF16_REL


@pytest.mark.cuda
@pytest.mark.parametrize("t", [9, 40])
def test_bf16_b2_is_four_b1_launches_bit_for_bit(cuda_device, t):
    n = 1001
    Xs, M = _inputs(14, n, 8, (4, n, t), cuda_device)
    Xs = Xs.to(torch.bfloat16).float()
    out = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.1, kernel_type="matern32", compute_dtype="mixed")
    for i in range(4):
        one = km.kernel_matmul_cuda(Xs, Xs, M[i], 1.0, 0.1, kernel_type="matern32",
                                    compute_dtype="mixed")
        assert torch.equal(out[i], one), i


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
def test_bf16_fused_step_two_runs_are_bit_identical(cuda_device, b):
    n, t = 2049, 9
    Xs, _ = _inputs(15, n, 8, (1,), cuda_device)
    Xs = Xs.to(torch.bfloat16).float()
    state, scalars = _state(16, b, n, t, cuda_device)
    runs = [km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.1,
                                  kernel_type="matern52", compute_dtype="mixed")
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


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
    buffer) take the CUDA-core path, and so does a bf16 head dim that is
    not a multiple of 16 (f32 dh 40, a multiple of 8, takes the 3xTF32
    route): same results, same tolerances."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [32, 40, 64, 112, 224, 256])
def test_flash_attention_f32_route_on_the_model_views(cuda_device, dh, causal):
    """The f32 tensor-core route (3xTF32) at every head-dim width it is
    built for, GQA 8 / 2, ragged, on the model's strided (b, s, h, dh)
    views: against the plain version and the CUDA-core kernel (the same
    values at a base that is not 16-byte aligned, which routes there),
    counted on its route, two runs the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain

    g = torch.Generator().manual_seed(dh * 2 + causal)
    q = torch.randn((2, 200, 8, dh), generator=g).to(cuda_device).transpose(1, 2)
    k = torch.randn((2, 333, 2, dh), generator=g).to(cuda_device).transpose(1, 2)
    v = torch.randn((2, 333, 2, dh), generator=g).to(cuda_device).transpose(1, 2)
    unaligned = [_off_alignment(t) for t in (q, k, v)]
    assert fa.b4_route(q, k, v) == "tf32 tensor cores"
    assert fa.b4_route(*unaligned) == "cuda cores"
    fa.reset_launch_counts()
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    again = fa.flash_attention_cuda(q, k, v, causal=causal)
    cores = fa.flash_attention_cuda(*unaligned, causal=causal)
    torch.cuda.synchronize()
    assert fa.route_launches == {"tensor cores": 0, "tf32 tensor cores": 2, "cuda cores": 1}
    assert torch.equal(out, again)
    ref = gqa_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(out, ref, **TOL)
    torch.testing.assert_close(cores, ref, **TOL)


def _off_alignment(x):
    """x's values in a contiguous tensor whose base lies 4 bytes past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _nan_bits(t, index):
    """t with the card's canonical NaN (bits 0x7fffffff) at ``index``."""
    t = t.clone()
    t.view(torch.int32)[index] = 0x7FFFFFFF
    return t


@pytest.mark.cuda
def test_tf32_split_rounds_as_cvt_rna(cuda_device):
    """The f32 routes' 3xTF32 split (``split`` in tf32_mma.cuh: hi =
    tf32(x), lo = tf32(x − hi)) against ``cvt.rna.tf32.f32`` (the library's
    ``tf32_split_check``) over every sign and exponent with mantissas at and
    around the rounding boundaries (so ±0, subnormals, ±inf and NaNs of
    high and low payloads) and 2²⁰ random bit patterns: hi and lo the bits
    of cvt.rna for every finite x, hi for ±inf too, and lo a NaN wherever
    x is a NaN or an infinity, so that the products are NaN."""
    import ctypes

    from repro_torch.kernels import build

    fn = build.load_library("flash_attention").tf32_split_check
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    mantissas = np.array([0, 1, 0xFFF, 0x1000, 0x1001, 0x1FFF, 0x2000, 0x3000, 0x400000,
                          0x401000, 0x7FE000, 0x7FEFFF, 0x7FF000, 0x7FFFFF], dtype=np.uint64)
    grid = ((np.arange(512, dtype=np.uint64) << 23)[:, None] | mantissas).ravel()
    rand = np.random.default_rng(0).integers(0, 2**32, 1 << 20, dtype=np.uint64)
    bits = np.concatenate([grid, rand]).astype(np.uint32)
    x = torch.from_numpy(bits.view(np.int32)).to(cuda_device)
    out = torch.empty((x.numel(), 4), dtype=torch.int32, device=cuda_device)
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(),
             torch.cuda.current_stream(cuda_device).cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    hi, lo, cvt_hi, cvt_lo = out.cpu().numpy().view(np.uint32).T

    def is_nan(u):
        return (u & 0x7FFFFFFF) > 0x7F800000

    nan, inf = is_nan(bits), (bits & 0x7FFFFFFF) == 0x7F800000
    finite = ~(nan | inf)
    for name, ours, cvt, where in (("hi", hi, cvt_hi, ~nan), ("lo", lo, cvt_lo, finite)):
        differ = np.flatnonzero(ours[where] != cvt[where])
        assert differ.size == 0, (name, [hex(int(u)) for u in bits[where][differ[:8]]])
    assert nan.sum() > 1000 and inf.sum() >= 2 and is_nan(lo[nan | inf]).all()


@pytest.mark.cuda
def test_f32_routes_carry_nan_as_the_plain_versions(cuda_device):
    """A NaN with the card's canonical bits in q (B4) or x (B5) comes out of
    the 3xTF32 routes as NaN where the plain versions give NaN: B4 the same
    NaNs as the plain version; B5 a NaN wherever the sequential recurrence
    has one and nowhere the plain chunked version is finite."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref, ssd_scan_ref

    g = torch.Generator().manual_seed(11)
    q = _nan_bits(torch.randn((2, 4, 96, 64), generator=g), (0, 1, 37, 5)).to(cuda_device)
    k, v = (torch.randn((2, 2, 96, 64), generator=g).to(cuda_device) for _ in range(2))
    assert fa.b4_route(q, k, v) == "tf32 tensor cores"
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    ref = gqa_attention_plain(q, k, v, causal=True)
    assert bool(ref.isnan().any())
    assert torch.equal(out.isnan(), ref.isnan())
    torch.testing.assert_close(out.nan_to_num(), ref.nan_to_num(), **TOL)

    x, dt, A, B, C = _ssd_inputs(12, 2, 4, 128, 64, 64, cuda_device, torch.float32)
    x = _nan_bits(x, (1, 2, 40, 7))
    assert ssd.b5_route(x, dt, A, B, C, 64) == "tf32 tensor cores"
    y = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=64)
    chunked = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=64)
    recurrence = ssd_scan_ref(*(t.double() for t in (x, dt, A, B, C)))
    assert bool(recurrence.isnan().any())
    assert bool(y.isnan()[recurrence.isnan()].all())
    assert not bool(y.isnan()[~chunked.isnan()].any())


@pytest.mark.cuda
@pytest.mark.parametrize("h,dh,ds,chunk", [(8, 64, 64, 128), (4, 64, 128, 128), (6, 32, 16, 16),
                                           (3, 48, 80, 64), (3, 128, 64, 64)])
def test_ssd_scan_f32_route_on_the_model_views(cuda_device, h, dh, ds, chunk):
    """The f32 tensor-core route (3xTF32) at zamba2's, mamba2-370m's and the
    reduced presets' widths and two others, on the model's strided f32
    views: against the plain chunked version, the recurrence and the
    CUDA-core kernel (forced), counted on its route, two runs the same
    bits."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref, ssd_scan_ref

    g = torch.Generator().manual_seed(h + dh + ds + chunk)
    b, l, di = 2, 256, h * dh
    xBC = torch.randn((b, l, di + 2 * ds), generator=g).to(cuda_device)
    x = xBC[..., :di].reshape(b, l, h, dh).transpose(1, 2)
    dt = F.softplus(torch.randn((b, l, h), generator=g) - 1.0).to(cuda_device).transpose(1, 2)
    A = -torch.linspace(1.0, 16.0, h, device=cuda_device)
    args = (x, dt, A, xBC[..., di : di + ds], xBC[..., di + ds :])
    assert ssd.b5_route(*args, chunk) == "tf32 tensor cores"
    ssd.reset_launch_counts()
    out = ssd.ssd_scan_cuda(*args, chunk=chunk)
    again = ssd.ssd_scan_cuda(*args, chunk=chunk)
    forced = ssd.ssd_scan_cuda(*args, chunk=chunk, _cuda_cores=True)
    torch.cuda.synchronize()
    assert ssd.route_launches == {"tensor cores": 0, "tf32 tensor cores": 2, "cuda cores": 1}
    assert torch.equal(out, again)
    tol = SSD_TOL[torch.float32]
    torch.testing.assert_close(out, ssd_scan_chunked_ref(*args, chunk=chunk), **tol)
    torch.testing.assert_close(out.double(), ssd_scan_ref(*(t.double() for t in args)), **tol)
    torch.testing.assert_close(out, forced, **tol)


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
def test_ssd_scan_cuda_core_layout(cuda_device):
    """The library's plan for the CUDA-core kernel: the whole state where
    its layout fits a block (zamba2's ds = 64), else slices of a multiple
    of 8 columns (mamba2-370m's ds = 128 at chunk 128: 48, 48, 32), and
    none where even slices of 8 do not fit (a 256-step chunk's decay
    matrix alone is past a block), which the wrapper refuses."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    assert ssd.cuda_core_layout(128, 64, 64) == (64, ssd.shared_bytes(128, 64, 64))
    assert ssd.cuda_core_layout(128, 64, 128) == (48, 217_792)
    width, nbytes = ssd.cuda_core_layout(256, 64, 64)
    assert width == 0 and nbytes > ssd.MAX_SHARED_BYTES
    for chunk, dh, ds in ((64, 32, 16), (128, 64, 64), (128, 64, 128), (64, 128, 128), (64, 64, 256)):
        width, nbytes = ssd.cuda_core_layout(chunk, dh, ds)
        assert width == ds or (width % 8 == 0 and 0 < width < ds)
        assert nbytes <= ssd.MAX_SHARED_BYTES
    x, dt, A, B, C = _ssd_inputs(22, 1, 1, 256, 64, 64, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="slices of 8"):
        ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_wide_state_on_the_cuda_cores(cuda_device, dtype):
    """mamba2-370m's state width, ds = 128 at dh = 64 and chunk 128: the
    whole-state layout does not fit a block, so the CUDA-core kernel stages
    the state in slices (3 of 48, 48, 32 columns); against the plain
    version and the recurrence, and two runs give the same bits."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref, ssd_scan_ref

    assert ssd.cuda_core_layout(128, 64, 128) == (48, 217_792)
    x, dt, A, B, C = _ssd_inputs(21, 2, 4, 256, 64, 128, cuda_device, dtype)
    before = ssd.launches
    out = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=128, _cuda_cores=True)
    again = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=128, _cuda_cores=True)
    torch.cuda.synchronize()
    assert ssd.launches == before + 2 and torch.equal(out, again)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(out.float(), ssd_scan_chunked_ref(x, dt, A, B, C, chunk=128).float(),
                               **tol)
    exact = ssd_scan_ref(*(t.double() for t in (x, dt, A, B, C)))
    torch.testing.assert_close(out.double(), exact, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,dh,causal",
    [(2, 8, 4, 96, 96, 64, True), (2, 8, 2, 96, 96, 64, True), (2, 16, 2, 80, 80, 128, True),
     (2, 24, 2, 80, 80, 128, True),
     (2, 8, 4, 40, 300, 64, False), (2, 4, 4, 1, 300, 64, False), (1, 4, 4, 300, 300, 64, False)],
)
def test_flash_attention_at_the_zoo_shapes(cuda_device, dtype, b, hq, hkv, sq, skv, dh, causal):
    """B4 at the zoo's head dims (64, 128), GQA groups of 2, 4, 8 and 12, and
    non-causal with sq != skv (whisper's cross-attention, in prefill and at
    one query in decode), in the model's (b, s, h, dh) views."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain

    g = torch.Generator().manual_seed(b * hq + sq + skv + dh)
    q = torch.randn((b, sq, hq, dh), generator=g).to(cuda_device, dtype).transpose(1, 2)
    k = torch.randn((b, skv, hkv, dh), generator=g).to(cuda_device, dtype).transpose(1, 2)
    v = torch.randn((b, skv, hkv, dh), generator=g).to(cuda_device, dtype).transpose(1, 2)
    out = fa.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    ref = gqa_attention_plain(q, k, v, causal=causal)
    tol = TOL if dtype == torch.float32 else dict(rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(out.float(), ref.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m", "mamba2-370m",
                                  "whisper-large-v3"])
def test_zoo_prefill_runs_the_kernels(cuda_device, arch):
    """The reduced zoo models' prefill on the card: B4 in every GQA layer
    (whisper: every encoder layer, decoder self- and cross-attention), B5
    in every Mamba-2 block, and the same logits as the plain paths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    bundle = build_model(cfg)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    params = bundle.init(gen, max_seq=64)
    batch = make_batch(cfg, 2, 32, seed=0, device=cuda_device)
    fa.reset_launch_counts()
    ssd.reset_launch_counts()
    out, _ = bundle.prefill(params, batch, 48)
    torch.cuda.synchronize()
    want = {"llama3.2-1b": (2, 0), "granite-moe-1b-a400m": (2, 0), "mamba2-370m": (0, 2),
            "whisper-large-v3": (6, 0)}[arch]
    assert (fa.launches, ssd.launches) == want
    plain, _ = bundle.prefill(params, batch, 48, use_kernels=False)
    assert (fa.launches, ssd.launches) == want
    torch.testing.assert_close(out, plain, rtol=1e-3, atol=1e-3)


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


def _world1_product(rank, world, X, M):
    """One rank's K̂·M through mode="cuda_sharded" on an NCCL world and
    through mode="cuda"; the rank's B1 launches and all-gathers for the
    sharded product."""
    from repro_torch.distributed import collective_counts, make_mesh, use_mesh
    from repro_torch.gp import KernelOperator, MaternKernel

    dev = torch.device("cuda", torch.cuda.current_device())
    X, M = X.to(dev), M.to(dev)
    kern = MaternKernel(torch.tensor(0.6, device=dev), torch.tensor(1.1, device=dev), nu=2.5)
    ref = KernelOperator(kern, X, mode="cuda").matmul(M)
    km.reset_launch_counts()
    with use_mesh(make_mesh((world,), ("data",))):
        out = KernelOperator(kern, X, mode="cuda_sharded").matmul(M)
    torch.cuda.synchronize()
    return ref.cpu(), out.cpu(), km.launch_counts()["launches"], collective_counts()["all_gathers"]


@pytest.mark.cuda
def test_sharded_product_world1_nccl_matches_cuda(cuda_device):
    """A world of one rank on NCCL (the collectives real at size 1):
    mode="cuda_sharded"'s K̂·M is one B1 launch and one all-gather, and
    equals mode="cuda"'s bit for bit (the band is every row)."""
    from repro_torch.distributed import spawn_world

    g = torch.Generator().manual_seed(0)
    X, M = torch.randn((3000, 8), generator=g), torch.randn((3000, 9), generator=g)
    ref, out, launches, gathers = spawn_world(_world1_product, 1, "nccl", args=(X, M),
                                              timeout=300)[0]
    assert (launches, gathers) == (1, 1)
    assert torch.equal(out, ref)


# -- LM training (no kernel: B4 / B5 have no backward) ----------------------------


@pytest.mark.cuda
def test_b4_and_b5_refuse_to_differentiate(cuda_device):
    """On inputs that require grad the two forward-only kernels raise
    (naming the missing backward) instead of returning an output that
    carries no gradient; under no_grad they run."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((1, 2, 16, 32), generator=g, device=cuda_device, requires_grad=True)
    k = torch.randn((1, 2, 16, 32), generator=g, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        fa.flash_attention_cuda(q, k, k)
    with torch.no_grad():
        assert fa.flash_attention_cuda(q, k, k).shape == q.shape
    x = torch.randn((1, 2, 32, 16), generator=g, device=cuda_device)
    dt = torch.rand((1, 2, 32), generator=g, device=cuda_device)
    A = -torch.rand((2,), generator=g, device=cuda_device)
    B = torch.randn((1, 32, 16), generator=g, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ssd.ssd_scan_cuda(x, dt, A, B, B.detach(), chunk=16)
    with torch.no_grad():
        assert ssd.ssd_scan_cuda(x, dt, A, B, B, chunk=16).shape == x.shape


def _llama_2_layers(device, dtype="float32"):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), num_layers=2, dtype=dtype)
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(0), max_seq=40)
    tokens = torch.randint(0, cfg.vocab_size, (4, 33), device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    return cfg, bundle, params, {"tokens": tokens}


@pytest.mark.cuda
def test_llama_train_step_reaches_every_leaf_on_the_card(cuda_device):
    """A 2-layer llama train step on the card, in f32: the loss runs the
    plain paths (no B4 launch), every leaf gets a non-zero gradient, the
    step moves every leaf (in bf16 the norm scales at 1.0 would keep an
    update below half their ulp: ROADMAP Queue C item 25)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import loss_and_grads, make_train_step
    from repro_torch.tree import tree_flatten_with_paths

    cfg, bundle, params, batch = _llama_2_layers(cuda_device)
    before = fa.launches
    loss, grads = loss_and_grads(bundle, params, batch)
    assert torch.isfinite(loss)
    for path, g in zip(*tree_flatten_with_paths(grads)):
        assert g is not None and bool(g.any()), path
    start = [p.clone() for p in tree_flatten_with_paths(params)[1]]
    step, init = make_train_step(bundle, lr=1e-3)
    params, opt, m = step(params, init(params), batch)
    assert fa.launches == before
    assert all(not torch.equal(a, b) for a, b in zip(start, tree_flatten_with_paths(params)[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-1b-a400m"])
def test_two_identical_train_steps_give_the_same_bits(cuda_device, arch):
    """The embedding's and the MoE dispatch's row gathers are indexing,
    whose backward sums in sorted order, so two bf16 steps from the same
    state give the same bits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=cuda_device).manual_seed(0), max_seq=72)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 65), device=cuda_device,
                                     generator=torch.Generator(device=cuda_device).manual_seed(1))}
    step, init = make_train_step(bundle, lr=1e-3)
    outs = []
    for _ in range(2):
        p = tree_map(torch.clone, params)
        p, opt, m = step(p, init(p), batch)
        outs.append(tree_leaves(p) + tree_leaves(opt.mu) + tree_leaves(opt.nu) + [m["loss"]])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.cuda
def test_rematerialised_train_step_gives_the_plain_steps_bits(cuda_device, monkeypatch):
    """A bf16 llama train step with the layers rematerialised
    (``models.layers.remat``) and with the helper patched out: the
    recompute runs the forward's kernels on the same inputs, so the loss,
    the gradient norm, the parameters and both moments keep their bits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, layers, make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), dtype="bfloat16")
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator(device=cuda_device).manual_seed(0), max_seq=72)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 65), device=cuda_device,
                                     generator=torch.Generator(device=cuda_device).manual_seed(1))}
    step, init = make_train_step(bundle, lr=1e-3)
    outs = []
    for remat in (layers.remat, lambda fn, *args: fn(*args)):
        monkeypatch.setattr(layers, "remat", remat)
        p = tree_map(torch.clone, params)
        p, opt, m = step(p, init(p), batch)
        outs.append(tree_leaves(p) + tree_leaves(opt.mu) + tree_leaves(opt.nu)
                    + [m["loss"], m["grad_norm"]])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


# -- the LM on a mesh (DTensor) ---------------------------------------------------


def _world1_mesh(rank, world):
    """On a world of one NCCL rank: B4 and B5 through their wrappers on
    head-sharded DTensors (a mesh dimension of size 1: the shard is the
    whole) against their plain versions, and the (1, 1) mesh train step
    of a 2-layer llama against the plain step."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref
    from repro_torch.models import make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    dev = torch.device("cuda", torch.cuda.current_device())
    dm = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("model",))
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 8, 128, 64), generator=g, device=dev)
    k, v = (torch.randn((2, 4, 128, 64), generator=g, device=dev) for _ in range(2))
    heads = [Shard(1)]
    before = fa.launches
    out = fa.flash_attention_cuda(*(DTensor.from_local(t, dm, heads) for t in (q, k, v)))
    res = {"b4_launches": fa.launches - before, "b4_placements": tuple(out.placements),
           "b4_err": float((out.to_local() - gqa_attention_plain(q, k, v)).abs().max())}
    x = torch.randn((2, 8, 128, 64), generator=g, device=dev)
    dt = torch.rand((2, 8, 128), generator=g, device=dev) * 0.1
    A = -torch.rand((8,), generator=g, device=dev)
    B, C = (torch.randn((2, 128, 32), generator=g, device=dev) for _ in range(2))
    before = ssd.launches
    out = ssd.ssd_scan_cuda(DTensor.from_local(x, dm, heads), DTensor.from_local(dt, dm, heads),
                            DTensor.from_local(A, dm, [Shard(0)]),
                            *(DTensor.from_local(t, dm, [Replicate()]) for t in (B, C)),
                            chunk=64)
    res.update(b5_launches=ssd.launches - before, b5_placements=tuple(out.placements),
               b5_err=float((out.to_local() - ssd_scan_chunked_ref(x, dt, A, B, C, chunk=64))
                            .abs().max()))

    _, bundle, params, batch = _llama_2_layers(dev)
    step, init = make_train_step(bundle, lr=1e-3)
    p = tree_map(torch.clone, params)
    p, opt, m = step(p, init(p), batch)
    mesh = sh.make_mesh((1, 1), ("data", "model"))
    with sh.use_mesh(mesh):
        dp = sh.distribute_tree(tree_map(torch.clone, params), sh.named_shardings(
            mesh, sh.params_shardings(params, bundle.stacked_paths)))
        db = {"tokens": sh.distribute(batch["tokens"], sh.NamedSharding(mesh, sh.p_batch(None)))}
        dp, dopt, dm_ = step(dp, init(dp), db)
        res["step_bitwise"] = bool(torch.equal(m["loss"], dm_["loss"]) and all(
            torch.equal(a.full_tensor(), b) for a, b in zip(
                tree_leaves(dp) + tree_leaves(dopt.mu) + tree_leaves(dopt.nu),
                tree_leaves(p) + tree_leaves(opt.mu) + tree_leaves(opt.nu))))
    return res


@pytest.fixture(scope="module")
def world1_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.distributed import spawn_world

    return spawn_world(_world1_mesh, 1, "nccl", timeout=300)[0]


@pytest.mark.cuda
def test_b4_and_b5_on_head_sharded_dtensors_match_plain(world1_mesh):
    """The wrappers' DTensor branch launches each kernel once on the rank's
    shard and wraps the result with the operands' placements."""
    from torch.distributed.tensor import Shard

    r = world1_mesh
    assert (r["b4_launches"], r["b4_placements"]) == (1, (Shard(1),))
    assert (r["b5_launches"], r["b5_placements"]) == (1, (Shard(1),))
    assert r["b4_err"] <= 2e-4 and r["b5_err"] <= 2e-3  # tests/test_flash_ssd_pallas.py's f32


@pytest.mark.cuda
def test_world1_mesh_train_step_is_the_plain_step(world1_mesh):
    """On a (1, 1) mesh of one NCCL rank every placement is replicated and
    the step is the plain single-process step, bit for bit."""
    assert world1_mesh["step_bitwise"]

"""SKI / KISS-GP end to end: the port's ``SKI`` against the reference's
(counterparts of tests/test_gp_models.py:146-182 and
tests/test_precision.py:225-235; serving is tests/test_torch_ski_serving.py).

The same numpy inputs go through both packages; the reference runs once
per quantity, in module-scoped fixtures, and its Rademacher draws are
replayed into the port.  The MLL and its gradients at fixed parameters over
a 5-iteration CG prefix (where two correct f32 runs still agree): MLL rtol
1e-4, gradients rtol 2e-3 / atol 1e-4.  The training bars run on the port
alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.preconditioner as port_precond
from repro.core import BBMMSettings as RefSettings
from repro.gp import SKI as RefSKI
from repro_torch import SKI, params_from_jax
from repro_torch.core import BBMMSettings, InterpolatedOperator, KroneckerOperator, tensor_leaves
from repro_torch.gp import RBFKernel, missing_protocol_methods, supports_streaming

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """SKI's many small ops run fastest on one thread, and spin on many
    under a parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

MLL_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
PREFIX = 5


def toy(seed, n, d=1, noise=0.05):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    y = (np.sin(4.0 * X[:, 0]) * (np.cos(3.0 * X[:, 1]) if d > 1 else 1.0)
         + noise * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _draws(key, rank, n, num):
    """The reference's probe draws: the pivoted-Cholesky preconditioner
    splits its key into a (rank, num) and an (n, num) Rademacher draw."""
    k1, k2 = jax.random.split(key)
    return [np.array(jax.random.rademacher(k1, (rank, num), dtype=jnp.float32)),
            np.array(jax.random.rademacher(k2, (n, num), dtype=jnp.float32))]


def _replay(monkeypatch, draws):
    queue = list(draws)

    def rademacher(generator, shape, dtype, device):
        g = queue.pop(0)
        assert g.shape == tuple(shape), (g.shape, shape)
        return torch.from_numpy(g).to(device=device, dtype=dtype)

    monkeypatch.setattr(port_precond, "_rademacher", rademacher)
    return queue


def _port_params(ref, X):
    return params_from_jax(jax.tree.map(np.asarray, ref.init_params(jnp.asarray(X))),
                           device="cpu", model="ski")


# d, n, grid per dimension of the MLL parity cases
MLL_CASES = {"1d": (1, 300, 64), "2d": (2, 200, 16)}


@pytest.fixture(scope="module", params=sorted(MLL_CASES))
def reference_mll(request):
    """The reference's −MLL and its gradients at its initial parameters,
    5 CG iterations, the default 10 probes and rank-5 preconditioner."""
    d, n, size = MLL_CASES[request.param]
    X, y = toy(20 + d, n, d)
    ref = RefSKI(grid_size=size, settings=RefSettings(max_cg_iters=PREFIX))
    key = jax.random.PRNGKey(3)
    loss, grads = jax.value_and_grad(ref.loss)(ref.init_params(jnp.asarray(X)),
                                               ref.prepare(jnp.asarray(X)), jnp.asarray(y), key)
    return dict(X=X, y=y, size=size, ref=ref, loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()},
                draws=_draws(key, 5, n, 10))


def test_mll_and_gradients_match_reference(monkeypatch, reference_mll):
    r = reference_mll
    gp = SKI(grid_size=r["size"], settings=BBMMSettings(max_cg_iters=PREFIX), device="cpu")
    params = _port_params(r["ref"], r["X"])
    for leaf in tensor_leaves(params):
        leaf.requires_grad_()
    queue = _replay(monkeypatch, r["draws"])
    loss = gp.loss(params, gp.prepare_inputs(r["X"]), r["y"], torch.Generator())
    loss.backward()
    assert not queue
    np.testing.assert_allclose(float(loss.detach()), r["loss"], rtol=MLL_RTOL)
    for name, g in r["grads"].items():
        assert params[name].grad is not None and bool(torch.any(params[name].grad != 0)), name
        np.testing.assert_allclose(params[name].grad.numpy(), g, **GRAD_TOL, err_msg=name)


def test_gradients_are_deterministic_and_integer_leaves_pass_through():
    """Two backward passes give the same bits; the operator's integer leaves
    (the taps and Wᵀ's order) reach the MLL without asking for a gradient,
    the weights as constants."""
    X, y = toy(24, 120, 2)
    gp = SKI(grid_size=12, settings=BBMMSettings(max_cg_iters=10), device="cpu")
    geom = gp.prepare_inputs(X)
    op = gp.operator(gp.init_params(X), geom)
    kinds = [leaf.dtype for leaf in tensor_leaves(op)]
    assert kinds.count(torch.int64) == 3 and isinstance(op.base.base, KroneckerOperator)

    def grads():
        params = {k: v.requires_grad_() for k, v in gp.init_params(X).items()}
        gp.loss(params, geom, y, torch.Generator().manual_seed(1)).backward()
        return [params[k].grad for k in sorted(params)]

    assert all(torch.equal(a, b) for a, b in zip(grads(), grads()))
    assert not geom["values"].requires_grad and geom["values"].grad is None


def test_geometry_is_the_references():
    X, _ = toy(25, 80, 2)
    gp, ref = SKI(grid_size=10, device="cpu"), RefSKI(grid_size=10)
    geom, rgeom = gp.prepare_inputs(X), ref.prepare(jnp.asarray(X))
    assert gp.prepare is not None and geom["indices"].dtype == torch.int64
    np.testing.assert_array_equal(geom["indices"].numpy(), np.asarray(rgeom["indices"]))
    np.testing.assert_allclose(geom["values"].numpy(), np.asarray(rgeom["values"]), atol=1e-6)
    flat = geom["indices"].reshape(-1)[geom["order"]]
    assert bool(torch.all(flat[1:] >= flat[:-1]))
    assert geom["offsets"].shape == (101,) and int(geom["offsets"][-1]) == flat.numel()


def test_ski_approximates_the_exact_kernel():
    """W·K_UU·Wᵀ ≈ K_XX for a smooth kernel on a dense enough grid."""
    X = np.random.default_rng(26).uniform(0, 1, (50, 1)).astype(np.float32)
    gp = SKI(grid_size=64, device="cpu")
    op = gp.operator(gp.init_params(X), gp.prepare(X))
    kern = RBFKernel(lengthscale=torch.tensor([0.5]), outputscale=torch.tensor(1.0))
    K_exact = kern(torch.from_numpy(X), torch.from_numpy(X))
    assert float((op.base.matmul(torch.eye(50)) - K_exact).abs().max()) < 5e-3


def test_protocol_and_rebuild_only():
    gp = SKI(grid_size=16, device="cpu")
    assert not missing_protocol_methods(gp)
    assert not supports_streaming(gp)
    with pytest.raises(ValueError, match="separable RBF"):
        SKI(kernel_type="matern52", device="cpu")


def test_fit_and_predict_1d():
    X, y = toy(28, 500)
    gp = SKI(grid_size=80, settings=BBMMSettings(max_cg_iters=30), device="cpu")
    params, hist = gp.fit(X, y, steps=60, lr=0.1)
    assert hist[-1] < hist[0]
    xs = np.linspace(-0.9, 0.9, 50, dtype=np.float32)[:, None]
    mean, var = gp.predict(params, gp.prepare_inputs(X), y, xs)
    mae = float(np.mean(np.abs(mean.numpy() - np.sin(4.0 * xs[:, 0]))))
    assert mae < 0.12, mae
    assert bool(torch.all(var > 0))


def test_2d_kronecker_grid():
    rng = np.random.default_rng(29)
    X = rng.uniform(0, 1, (200, 2)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) * np.cos(3 * X[:, 1])).astype(np.float32)
    gp = SKI(grid_size=24, settings=BBMMSettings(max_cg_iters=30), device="cpu")
    params, hist = gp.fit(X, y, steps=40, lr=0.1)
    assert hist[-1] < hist[0]
    mean, _ = gp.predict(params, gp.prepare_inputs(X), y, X[:20])
    assert float(np.mean(np.abs(mean.numpy() - y[:20]))) < 0.15


def test_mixed_loss_finite_and_close_and_fuse_cg_unfused():
    """precision="mixed" (the Toeplitz product stays f32; mBCG refreshes)
    gives a finite loss within the reference's 5e-2 of "highest";
    fuse_cg=True runs the unfused loop, the same loss bit for bit."""
    X, y = toy(30, 256)
    high = SKI(grid_size=64, device="cpu")
    geom, params = high.prepare(X), high.init_params(X)
    mixed = SKI(grid_size=64, precision="mixed", device="cpu")
    assert mixed.settings.precision == "mixed"
    mixed_op = mixed.operator(params, geom).with_compute_dtype("mixed")
    assert isinstance(mixed_op.base, InterpolatedOperator)
    assert mixed_op.base.base.with_compute_dtype("mixed") is mixed_op.base.base

    def loss(model):
        return float(model.loss(params, geom, y, torch.Generator().manual_seed(8)))

    lh, lm = loss(high), loss(mixed)
    assert np.isfinite(lm) and abs(lm - lh) / abs(lh) < 5e-2
    fused = SKI(grid_size=64, fuse_cg=True, settings=BBMMSettings(precond_rank=0), device="cpu")
    plain = SKI(grid_size=64, settings=BBMMSettings(precond_rank=0), device="cpu")
    assert fused.settings.fuse_cg and loss(fused) == loss(plain)


def test_params_from_jax_ski():
    X, _ = toy(31, 40, 2)
    ref = RefSKI(grid_size=8)
    rp = jax.tree.map(np.asarray, ref.init_params(jnp.asarray(X)))
    params = params_from_jax(rp, device="cpu", model="ski")
    own = SKI(grid_size=8, device="cpu").init_params(X)
    assert params.keys() == own.keys()
    for k in own:
        assert params[k].shape == own[k].shape and torch.allclose(params[k], own[k]), k
    with pytest.raises(ValueError, match="vector"):
        params_from_jax(dict(rp, raw_lengthscale=np.float32(0.0)), device="cpu", model="ski")

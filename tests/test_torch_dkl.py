"""Deep kernel learning: the port's ``DeepKernel``, ``mlp_apply`` and
``DKLExactGP`` against the reference's.

The reference's network weights (``mlp_init`` from ``PRNGKey(7)``) carry
over by ``params_from_jax(..., model="dkl")``; its Rademacher draws are
replayed into the port.  The network is a list of ``{"w", "b"}`` dicts,
which the differentiable MLL walks (``tensor_leaves``), so the backward
must reach every weight: each gradient is nonzero and within 1e-3 of its
size of the reference's (tests/test_torch_training.py), the MLL rtol 1e-4.
The one exception is the last layer's bias: a stationary kernel of the
features is invariant to shifting them all, so its gradient is 0 up to
rounding in both packages (≤ 1e-4 of the largest weight gradient).
As there, σ² = 0.5 and cg_tol 1e-3 stop CG while two correct f32 runs still
agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.preconditioner as port_precond
from repro.core import BBMMSettings as RefSettings
from repro.gp import DKLExactGP as RefDKL
from repro.gp import mlp_apply as ref_mlp_apply
from repro.gp import mlp_init as ref_mlp_init
from repro_torch import DKLExactGP, params_from_jax
from repro_torch.core import BBMMSettings, replace_tensor_leaves, tensor_leaves
from repro_torch.gp import DeepKernel, KernelOperator, mlp_apply, mlp_init

jax.config.update("jax_platform_name", "cpu")

N, D = 100, 3
MLL_RTOL = 1e-4
GRAD_RTOL = 1e-3
SETTINGS = dict(num_probes=4, max_cg_iters=40, cg_tol=1e-3, precond_rank=5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    y = (np.sign(X[:, 0]) * np.sin(8 * X[:, 0]) + 0.05 * rng.standard_normal(N)).astype(np.float32)
    return X, y


def _draws(key, rank, n, num):
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


def _pair(hidden=(8, 2)):
    ref = RefDKL(hidden=hidden, settings=RefSettings(**SETTINGS))
    rp = ref.init_params(D)
    rp["raw_noise"] = jnp.log(jnp.expm1(jnp.float32(0.5)))
    gp = DKLExactGP(hidden=hidden, settings=BBMMSettings(**SETTINGS), device="cpu")
    return ref, rp, gp, params_from_jax(jax.tree.map(np.asarray, rp), device="cpu", model="dkl")


def test_mlp_and_deep_kernel_match_reference():
    X, _ = _data()
    rnet = ref_mlp_init(jax.random.PRNGKey(3), (D, 16, 8, 2))
    net = params_from_jax({"net": jax.tree.map(np.asarray, rnet), "raw_lengthscale": 0.0,
                           "raw_outputscale": 0.0, "raw_noise": 0.0}, device="cpu",
                          model="dkl")["net"]
    np.testing.assert_allclose(mlp_apply(net, torch.from_numpy(X)).numpy(),
                               np.asarray(ref_mlp_apply(rnet, jnp.asarray(X))), rtol=1e-5, atol=1e-6)
    ref, rp, gp, params = _pair()
    K = gp.kernel(params)
    assert isinstance(K, DeepKernel)
    rK = ref.kernel(rp)
    np.testing.assert_allclose(K(torch.from_numpy(X), torch.from_numpy(X[:7])).numpy(),
                               np.asarray(rK(jnp.asarray(X), jnp.asarray(X[:7]))), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(K.diag(torch.from_numpy(X)).numpy(),
                                  np.asarray(rK.diag(jnp.asarray(X))))
    # a port-drawn network: He scaling, zero biases, the requested widths
    own = mlp_init(torch.Generator().manual_seed(0), (D, 32, 32, 2))
    assert [tuple(layer["w"].shape) for layer in own] == [(D, 32), (32, 32), (32, 2)]
    assert all(not layer["b"].any() for layer in own)
    assert abs(float(own[1]["w"].std()) - (2.0 / 32) ** 0.5) < 0.05


def test_tensor_leaves_walk_the_network():
    """The operator's leaves include every weight of the network (a list of
    dicts) and not the feature callable; replacing them rebuilds the same
    structure."""
    _, _, gp, params = _pair()
    op = gp.operator(params, _data()[0])
    leaves = tensor_leaves(op)
    for layer in params["net"]:
        assert any(x is layer["w"] for x in leaves) and any(x is layer["b"] for x in leaves)
    swapped = replace_tensor_leaves(op, [x.clone() for x in leaves])
    net = swapped.base.kernel.net_params
    assert isinstance(net, list) and set(net[0]) == {"w", "b"}
    assert swapped.base.kernel.feature_fn is mlp_apply
    assert all(torch.equal(a, b) for a, b in zip(tensor_leaves(swapped), leaves))


@pytest.mark.parametrize("hidden", [(8, 2), (32, 32, 2)])
def test_dkl_loss_and_every_weight_gradient_match_reference(monkeypatch, hidden):
    X, y = _data()
    ref, rp, gp, params = _pair(hidden)
    key = jax.random.PRNGKey(5)
    rloss, rgrads = jax.value_and_grad(ref.loss)(rp, jnp.asarray(X), jnp.asarray(y), key)
    queue = _replay(monkeypatch, _draws(key, 5, N, SETTINGS["num_probes"]))
    leaves = tensor_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_()
    loss = gp.loss(params, X, y, torch.Generator())
    loss.backward()
    assert not queue
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=MLL_RTOL)
    net = params["net"]
    scale = max(float(layer["w"].grad.abs().max()) for layer in net)
    for k, layer in enumerate(net):
        for name in ("w", "b"):
            g, rg = layer[name].grad, np.asarray(rgrads["net"][k][name])
            if (k, name) == (len(net) - 1, "b"):  # shift invariance: 0 up to rounding
                assert float(g.abs().max()) <= 1e-4 * scale
                assert np.abs(rg).max() <= 1e-4 * scale
                continue
            assert g is not None and float(g.abs().max()) > 0, (k, name)
            assert _rel(g.numpy(), rg) <= GRAD_RTOL, (k, name)
    for name in ("raw_lengthscale", "raw_outputscale", "raw_noise"):
        assert _rel(params[name].grad.numpy(), rgrads[name]) <= GRAD_RTOL, name


def test_dkl_fit_matches_reference(monkeypatch):
    """Three Adam steps (lr 0.01) against the reference's fit, its key
    splits replayed: every weight moves as the reference's does (but the
    last bias, whose gradient is rounding: Adam's normalized step moves it
    by at most lr a step in either package)."""
    X, y = _data(1)
    ref, rp, gp, params0 = _pair()
    ref_params, ref_hist = ref.fit(jnp.asarray(X), jnp.asarray(y), steps=3)
    rp0 = ref.init_params(jnp.asarray(X))
    params0 = params_from_jax(jax.tree.map(np.asarray, rp0), device="cpu", model="dkl")
    key, draws = jax.random.PRNGKey(8), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws += _draws(sub, 5, N, SETTINGS["num_probes"])
    queue = _replay(monkeypatch, draws)
    monkeypatch.setattr(gp, "init_params", lambda X: params0)
    params, hist = gp.fit(X, y, steps=3)
    assert not queue
    np.testing.assert_allclose(hist, ref_hist, rtol=MLL_RTOL)
    net = params["net"]
    for k, layer in enumerate(net):
        for name in ("w", "b"):
            if (k, name) == (len(net) - 1, "b"):
                assert float((layer[name] - params0["net"][k][name]).abs().max()) <= 3 * 0.01 + 1e-6
                continue
            assert not torch.equal(layer[name], params0["net"][k][name]), (k, name)
            assert _rel(layer[name].numpy(), ref_params["net"][k][name]) <= GRAD_RTOL, (k, name)


def test_dkl_runs_dense_and_rejects_the_kernel_path():
    """The deep kernel is not stationary in X: the model's operator is dense
    (no kernel launch), and a cuda-mode operator over it raises."""
    X, _ = _data()
    _, _, gp, params = _pair()
    op = gp.operator(params, X)
    assert op.base.mode == "dense"
    with pytest.raises(TypeError, match="stationary"):
        KernelOperator(kernel=gp.kernel(params), X=torch.from_numpy(X), mode="cuda").prepare()


def test_params_from_jax_checks_the_network():
    base = {"raw_lengthscale": 0.0, "raw_outputscale": 0.0, "raw_noise": 0.0}
    with pytest.raises(ValueError, match="does not follow"):
        params_from_jax({**base, "net": [{"w": np.zeros((3, 4)), "b": np.zeros(4)},
                                         {"w": np.zeros((5, 2)), "b": np.zeros(2)}]},
                        device="cpu", model="dkl")
    with pytest.raises(ValueError, match="does not match"):
        params_from_jax({**base, "net": [{"w": np.zeros((3, 4)), "b": np.zeros(3)}]},
                        device="cpu", model="dkl")
    with pytest.raises(ValueError, match="DKLExactGP parameters"):
        params_from_jax(base, device="cpu", model="dkl")

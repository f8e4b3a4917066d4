"""The training slice: the port's differentiable MLL and ``fit_gp`` against
the reference's.

The same numpy data and hyperparameters go through
``jax.value_and_grad`` of the reference's ``ExactGP.loss`` (``mode="dense"``)
and through the port's ``ExactGP.loss`` + ``backward()`` in ``mode="dense"``,
``mode="cuda"`` (CPU tensors: the kernels' plain versions) and
``mode="cuda", fuse_cg=True``.  jax and torch draw different numbers from
one seed, so every Rademacher draw the port makes is replayed from the
reference's key splits by monkeypatching the port's ``_rademacher``.

Tolerances: the MLL rtol 1e-4 (tests/test_fused_cg.py:309,
tests/test_kernel_matmul_pallas.py:171); each gradient and each fitted
parameter rtol 1e-3 of its size, the solve tolerance (:311) — the BBMM
gradient is linear in the solves.  As in tests/test_torch_exact_serving.py,
the data and ``cg_tol`` stop CG while two correct f32 runs still agree.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.preconditioner as port_precond
from repro.core import BBMMSettings as RefSettings
from repro.gp import ExactGP as RefExactGP
from repro_torch import ExactGP, params_from_jax
from repro_torch.core import (
    BBMMSettings,
    SolveFailure,
    SolveHealthWarning,
    replace_tensor_leaves,
    tensor_leaves,
)
from repro_torch.gp import fit_gp

N, D = 120, 3
MLL_RTOL = 1e-4
GRAD_RTOL = 1e-3
SETTINGS = dict(num_probes=4, max_cg_iters=40, cg_tol=1e-3)
PATHS = {  # port path → (mode, fuse_cg, precond_rank)
    "dense": ("dense", False, 5),
    "cuda": ("cuda", False, 5),
    "cuda_fused": ("cuda", True, 0),
}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) * np.cos(2 * X[:, -1])
         + 0.05 * rng.standard_normal(N)).astype(np.float32)
    return X, y


def _draws(key, precond_rank, num):
    """The reference's Rademacher draws for one ``sample_probes(key, …)``,
    in the order the port's sampler asks for them."""
    if precond_rank == 0:
        return [np.array(jax.random.rademacher(key, (N, num), dtype=jnp.float32))]
    k1, k2 = jax.random.split(key)
    return [np.array(jax.random.rademacher(k1, (precond_rank, num), dtype=jnp.float32)),
            np.array(jax.random.rademacher(k2, (N, num), dtype=jnp.float32))]


def _replay(monkeypatch, draws):
    queue = list(draws)

    def rademacher(generator, shape, dtype, device):
        g = queue.pop(0)
        assert g.shape == tuple(shape), (g.shape, shape)
        return torch.from_numpy(g).to(device=device, dtype=dtype)

    monkeypatch.setattr(port_precond, "_rademacher", rademacher)
    return queue


def _models(path, kernel_type):
    mode, fuse, rank = PATHS[path]
    ref = RefExactGP(kernel_type=kernel_type, mode="dense",
                     settings=RefSettings(**SETTINGS, precond_rank=rank))
    ours = ExactGP(kernel_type=kernel_type, mode=mode, fuse_cg=fuse, device="cpu",
                   settings=BBMMSettings(**SETTINGS, precond_rank=rank))
    return ref, ours


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("kernel_type,ard", [("matern52", False), ("rbf", True)])
def test_mll_and_gradients_match_reference(monkeypatch, path, kernel_type, ard):
    X, y = _data()
    ref, ours = _models(path, kernel_type)
    ref_params = ref.init_params(D, ard=ard)
    if ard:
        ref_params["raw_lengthscale"] = ref_params["raw_lengthscale"] + jnp.array([0.0, 0.3, -0.2])
    ref_params["raw_noise"] = jnp.log(jnp.expm1(jnp.float32(0.5)))
    key = jax.random.PRNGKey(7)
    ref_loss, ref_grads = jax.value_and_grad(ref.loss)(ref_params, jnp.asarray(X), jnp.asarray(y), key)
    queue = _replay(monkeypatch, _draws(key, PATHS[path][2], SETTINGS["num_probes"]))

    params = {k: v.requires_grad_() for k, v in params_from_jax(
        {k: np.asarray(v) for k, v in ref_params.items()}, device="cpu").items()}
    loss = ours.loss(params, X, y, torch.Generator())
    loss.backward()
    assert not queue  # every draw was the reference's
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=MLL_RTOL)
    for name, g in params.items():
        assert _rel(g.grad.numpy(), ref_grads[name]) <= GRAD_RTOL, name


@pytest.mark.parametrize("path", ["dense", "cuda_fused"])
def test_three_step_fit_matches_reference(monkeypatch, path):
    """fit_gp's loss history and parameters after 3 Adam steps (lr 0.1)
    against the reference's fit_gp, each step's probes replayed from the
    reference's key splits."""
    X, y = _data(1)
    ref, ours = _models(path, "matern52")
    ref_params, ref_hist = ref.fit(jnp.asarray(X), jnp.asarray(y), steps=3)
    key, draws = jax.random.PRNGKey(0), []
    for _ in range(3):
        key, sub = jax.random.split(key)
        draws += _draws(sub, PATHS[path][2], SETTINGS["num_probes"])
    queue = _replay(monkeypatch, draws)
    steps = []
    params, hist = ours.fit(X, y, steps=3, callback=lambda i, loss: steps.append((i, loss)))
    assert not queue
    assert steps == list(enumerate(hist))
    np.testing.assert_allclose(hist, ref_hist, rtol=MLL_RTOL)
    for name, v in params.items():
        assert _rel(v.numpy(), ref_params[name]) <= GRAD_RTOL, name


class _PoisonedGP(ExactGP):
    """An ExactGP whose second loss evaluation is NaN."""

    calls: int = 0

    def loss(self, params, data, y, generator):
        self.calls += 1
        loss = super().loss(params, data, y, generator)
        return loss * float("nan") if self.calls == 2 else loss


# converged solves, so that on_failure="raise" sees only the poisoned loss
QUICK = dict(num_probes=3, max_cg_iters=60, cg_tol=1e-2)


def _poisoned(on_failure):
    return _PoisonedGP(kernel_type="rbf", device="cpu",
                       settings=BBMMSettings(**QUICK, on_failure=on_failure))


def test_non_finite_loss_warn_skips_the_update():
    X, y = _data(2)
    seen = []
    with pytest.warns(SolveHealthWarning, match="skipping the poisoned update"):
        params, hist = fit_gp(_poisoned("warn"), X, y, steps=2, callback=lambda i, v: seen.append(v))
    assert np.isfinite(hist[0]) and np.isnan(hist[1]) and len(seen) == 2
    one, _ = fit_gp(ExactGP(kernel_type="rbf", device="cpu", settings=BBMMSettings(**QUICK)),
                    X, y, steps=1)
    for name in params:  # the poisoned step left the parameters as step 0 did
        torch.testing.assert_close(params[name], one[name])


@pytest.mark.parametrize("on_failure,error,match", [
    ("raise", SolveFailure, "non-finite loss"),
    ("degrade", NotImplementedError, "step 10"),
])
def test_non_finite_loss_raise_and_degrade(on_failure, error, match):
    X, y = _data(3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SolveHealthWarning)
        with pytest.raises(error, match=match):
            fit_gp(_poisoned(on_failure), X, y, steps=2)


def test_non_finite_inputs_are_rejected():
    X, y = _data(4)
    X[5, 1] = np.nan
    with pytest.raises(ValueError, match="X contains 1 non-finite"):
        fit_gp(ExactGP(device="cpu"), X, y, steps=1)
    X[5, 1] = 0.0
    y[3] = np.inf
    with pytest.raises(ValueError, match="y contains 1 non-finite"):
        fit_gp(ExactGP(device="cpu"), X, y, steps=1)


def test_operator_tensor_leaves_round_trip():
    """The MLL's gradient reaches every tensor the operator holds: its
    leaves are the inputs, the kernel's hyperparameters and the noise."""
    X, _ = _data(5)
    gp = ExactGP(kernel_type="matern32", mode="cuda", device="cpu")
    params = gp.init_params(X, ard=True)
    op = gp.operator(params, X)
    leaves = tensor_leaves(op)
    kern = op.base.kernel
    assert [id(v) for v in leaves] == [id(kern.lengthscale), id(kern.outputscale),
                                       id(op.base.X), id(op.sigma2)]
    new = [v + 1.0 for v in leaves]
    op2 = replace_tensor_leaves(op, new)
    assert all(a is b for a, b in zip(tensor_leaves(op2), new))
    assert op2.base.mode == "cuda" and op2.base.kernel.nu == 1.5
    with pytest.raises(ValueError, match="more leaves"):
        replace_tensor_leaves(op, new + [new[0]])

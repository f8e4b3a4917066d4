"""Serving SKI: the port's posterior cache against the reference's
(counterpart of tests/test_posterior_cache.py:179-203), in its own file so
that a parallel run places the reference's cache build (~15 s of JAX
compilation) beside the MLL cases of tests/test_torch_ski.py.

The reference's draws are replayed into the port's cache build.  The
served mean within 1e-4 of the reference's; the port's ``predict`` mean
bit for bit its ``predict_cached`` mean, the cached variance no lower than
the solved one − 1e-3 (the reference's bar); queries run no CG; two builds
give the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.inference as inference_mod
import repro_torch.core.preconditioner as port_precond
from repro.core import BBMMSettings as RefSettings
from repro.gp import SKI as RefSKI
from repro_torch import SKI, params_from_jax
from repro_torch.core import BBMMSettings

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """SKI's many small ops run fastest on one thread, and spin on many
    under a parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

MEAN_TOL = dict(rtol=1e-4, atol=1e-4)


def toy(seed, n):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    return X, (np.sin(4.0 * X[:, 0]) + 0.05 * rng.standard_normal(n)).astype(np.float32)


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


CACHE_CASE = dict(n=150, size=48, iters=30, queries=20)


@pytest.fixture(scope="module")
def reference_cache():
    """The reference's served mean (tests/test_posterior_cache.py:179-203)
    and the draws of its cache build (its default key, PRNGKey(0))."""
    c = CACHE_CASE
    X, y = toy(27, c["n"])
    Xs = np.linspace(-0.9, 0.9, c["queries"], dtype=np.float32)[:, None]
    ref = RefSKI(grid_size=c["size"], settings=RefSettings(max_cg_iters=c["iters"]))
    geom, params = ref.prepare(jnp.asarray(X)), ref.init_params(jnp.asarray(X))
    cache = ref.posterior_cache(params, geom, jnp.asarray(y))
    mean, _ = ref.predict_cached(params, geom, cache, jnp.asarray(Xs))
    return dict(X=X, y=y, Xs=Xs, ref=ref, mean=np.asarray(mean),
                draws=_draws(jax.random.PRNGKey(0), 5, c["n"], 10))


def test_serving_matches_reference_and_predict_bitwise(monkeypatch, reference_cache):
    r, c = reference_cache, CACHE_CASE
    gp = SKI(grid_size=c["size"], settings=BBMMSettings(max_cg_iters=c["iters"]), device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, r["ref"].init_params(jnp.asarray(r["X"]))),
                             device="cpu", model="ski")
    geom = gp.prepare_inputs(r["X"])
    queue = _replay(monkeypatch, r["draws"])
    cache = gp.posterior_cache(params, geom, r["y"])
    assert not queue
    monkeypatch.undo()

    calls = {"n": 0}
    real_mbcg = inference_mod.mbcg
    monkeypatch.setattr(inference_mod, "mbcg",
                        lambda *a, **k: (calls.__setitem__("n", calls["n"] + 1), real_mbcg(*a, **k))[1])
    mean_c, var_c = gp.predict_cached(params, geom, cache, r["Xs"])
    assert calls["n"] == 0  # queries run no CG
    np.testing.assert_allclose(mean_c.numpy(), r["mean"], **MEAN_TOL)

    own = gp.posterior_cache(params, geom, r["y"])
    mean_own, var_own = gp.predict_cached(params, geom, own, r["Xs"])
    mean_p, var_p = gp.predict(params, geom, r["y"], r["Xs"])
    assert torch.equal(mean_own, mean_p)  # predict's mean IS the cache's
    assert bool(torch.all(var_own > 0)) and bool(torch.all(var_own >= var_p - 1e-3))
    # two builds, the same bits
    again = gp.posterior_cache(params, geom, r["y"])
    assert torch.equal(own.alpha, again.alpha) and torch.equal(own.basis, again.basis)

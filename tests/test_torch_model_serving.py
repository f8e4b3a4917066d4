"""Serving the model zoo through one protocol: the port's ``GPModel``
surface and ``PosteriorSession`` for SGPR, BLR, DKL, SKI and the multitask
GP beside ExactGP (counterpart of the zoo half of tests/test_serving.py),
and the ``gp_serve`` driver for each ported model on the CPU.  SKI is
rebuild-only, as in the reference: every observe rebuilds.

Tolerances: a Woodbury append against a rebuild rtol 1e-3 / atol 1e-4
(tests/test_serving.py:213-218), with zero CG solves; the served Woodbury
mean against the reference's session rtol 1e-3 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.inference as inference_mod
from repro.gp import SGPR as RefSGPR
from repro.gp import SKI as RefSKI
from repro.gp import BayesianLinearRegression as RefBLR
from repro.gp import DKLExactGP as RefDKL
from repro.serving import PosteriorSession as RefSession
from repro.serving import fingerprint as ref_fingerprint
from repro_torch import (
    SGPR,
    SKI,
    BayesianLinearRegression,
    DKLExactGP,
    ExactGP,
    MultitaskGP,
    params_from_jax,
)
from repro_torch.core import BBMMSettings
from repro_torch.gp import (
    PROTOCOL_METHODS,
    WoodburyCache,
    fit_gp,
    missing_protocol_methods,
    supports_streaming,
    to_long_format,
)
from repro_torch.launch import gp_serve
from repro_torch.serving import PosteriorSession, fingerprint


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


jax.config.update("jax_platform_name", "cpu")

STREAM_TOL = dict(rtol=1e-3, atol=1e-4)


def toy(seed, n, d=1, noise=0.05):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    y = (np.sin(4.0 * X[:, 0]) + noise * rng.standard_normal(n)).astype(np.float32)
    return X, y


def multitask_toy(seed, n, T=2):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    Y = np.sin(4.0 * X) * (1.0 + 0.3 * np.arange(T)) + 0.05 * rng.standard_normal((n, T))
    return to_long_format(X, Y)


def all_models():
    s = BBMMSettings(num_probes=6, max_cg_iters=30)
    return {
        "exact": (ExactGP(mode="cuda", settings=s, device="cpu"), dict(lr=0.1)),
        "sgpr": (SGPR(num_inducing=20, device="cpu"), dict(lr=0.05)),
        "ski": (SKI(grid_size=32, settings=s, device="cpu"), dict(lr=0.1)),
        "dkl": (DKLExactGP(hidden=(8, 2), settings=s, device="cpu"), dict(lr=0.01)),
        "blr": (BayesianLinearRegression(device="cpu"), dict(lr=0.05)),
        "multitask": (MultitaskGP(num_tasks=2, mode="cuda", device="cpu",
                                  settings=BBMMSettings(num_probes=6, max_cg_iters=30,
                                                        precond_rank=0)), dict(lr=0.1)),
    }


def _data(name, seed, n):
    return multitask_toy(seed, n // 2) if name == "multitask" else toy(seed, n)


def _queries(name, k):
    q = np.linspace(-0.8, 0.8, k, dtype=np.float32)[:, None]
    if name == "multitask":
        return to_long_format(q, task_ids=np.arange(k) % 2, num_tasks=2)
    return q


class _CGCounter:
    """Counts mBCG entries through the engine (the 'full CG solve' guard)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = inference_mod.mbcg

        def counting(*a, **k):
            self.calls += 1
            return real(*a, **k)

        monkeypatch.setattr(inference_mod, "mbcg", counting)


class TestProtocolConformance:
    def test_all_models_conform_structurally(self):
        for name, (model, _) in all_models().items():
            assert not missing_protocol_methods(model), name
            for meth in PROTOCOL_METHODS:
                assert callable(getattr(model, meth)), (name, meth)

    def test_streaming_support_map(self):
        for name, (model, _) in all_models().items():
            assert supports_streaming(model) == (name != "ski"), name  # SKI: rebuild-only

    @pytest.mark.parametrize("name", ["exact", "sgpr", "dkl", "blr", "multitask", "ski"])
    def test_fit_roundtrip_identical_through_shared_driver(self, name):
        """model.fit ≡ fit_gp bitwise (same generator seed, same loop), and
        the fitted parameters serve through the uniform surface."""
        model, kw = all_models()[name]
        X, y = _data(name, 5, 80)
        p1, h1 = model.fit(X, y, steps=3)
        p2, h2 = fit_gp(model, X, y, steps=3, **kw)
        assert h1 == h2
        from repro_torch.core import tensor_leaves

        assert all(torch.equal(a, b) for a, b in zip(tensor_leaves(p1), tensor_leaves(p2)))
        mean, var = model.predict(p1, model.prepare_inputs(X), y, _queries(name, 9))
        assert mean.shape == (9,) and bool(torch.all(var > 0))

    @pytest.mark.parametrize("name", ["exact", "sgpr", "dkl", "blr", "multitask", "ski"])
    def test_cached_mean_bitwise_across_zoo(self, name):
        """predict and predict_cached give the same mean bit for bit for
        every model — the protocol-wide serving invariant."""
        model, _ = all_models()[name]
        X, y = _data(name, 6, 90)
        params = model.init_params(X)
        data = model.prepare_inputs(X)
        cache = model.posterior_cache(params, data, y)
        assert isinstance(cache, WoodburyCache) == (name in ("sgpr", "blr"))
        Xs = _queries(name, 11)
        mean_c, _ = model.predict_cached(params, data, cache, Xs)
        mean_p, _ = model.predict(params, data, y, Xs)
        assert torch.equal(mean_c, mean_p)


class TestStreaming:
    @pytest.mark.parametrize("name", ["sgpr", "blr"])
    def test_woodbury_observe_matches_rebuild_zero_cg(self, monkeypatch, name):
        """observe + query ≡ a rebuild on the concatenated data, with ZERO
        CG solves in the append / query path; the served mean is the
        reference session's on the same data and parameters."""
        X, y = toy(10, 150, d=2)
        Xn, yn = toy(11, 5, d=2)
        Xs = np.random.default_rng(12).uniform(-1, 1, (20, 2)).astype(np.float32)
        if name == "sgpr":
            ref, model, key = RefSGPR(num_inducing=20), SGPR(num_inducing=20, device="cpu"), "sgpr"
        else:
            ref, model, key = RefBLR(), BayesianLinearRegression(device="cpu"), "blr"
        rp = ref.init_params(jnp.asarray(X))
        params = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu", model=key)
        session = PosteriorSession(model, params, X, y)
        counter = _CGCounter(monkeypatch)
        assert session.observe(Xn, yn) == "append"
        mean_s, var_s = session.query(Xs)
        assert counter.calls == 0
        Xf, yf = np.concatenate([X, Xn]), np.concatenate([y, yn])
        mean_r, var_r = PosteriorSession(model, params, Xf, yf).query(Xs)
        np.testing.assert_allclose(mean_s.numpy(), mean_r.numpy(), **STREAM_TOL)
        np.testing.assert_allclose(var_s.numpy(), var_r.numpy(), **STREAM_TOL)
        rsession = RefSession(ref, rp, jnp.asarray(X), jnp.asarray(y))
        rsession.observe(jnp.asarray(Xn), jnp.asarray(yn))
        rmean, _ = rsession.query(jnp.asarray(Xs))
        np.testing.assert_allclose(mean_s.numpy(), np.asarray(rmean), **STREAM_TOL)

    @pytest.mark.parametrize("name", ["sgpr", "exact"])
    def test_append_hashes_only_the_appended_rows(self, monkeypatch, name):
        """observe re-stamps the state by chaining the previous fingerprint
        with the appended rows' digest: no leaf of n rows is copied to the
        host, the served cache is not stale, and the stamp is the chain."""
        import repro_torch.serving.session as session_mod

        model, _ = all_models()[name]
        X, y = toy(13, 120)
        session = PosteriorSession(model, model.init_params(X), X, y)
        fp0 = session.cache_info.fingerprint
        hashed = []
        real = session_mod.fingerprint

        def recording(tree):
            hashed.extend(int(leaf.shape[0]) for leaf in session_mod._leaves(tree)
                          if getattr(leaf, "ndim", 0))
            return real(tree)

        monkeypatch.setattr(session_mod, "fingerprint", recording)
        Xn, yn = X[:4] * 0.9, y[:4]
        assert session.observe(Xn, yn) == "append"
        assert hashed and max(hashed) == 4
        assert not session.stale()
        assert session.cache_info.fingerprint == session_mod.chain_fingerprint(
            fp0, (torch.from_numpy(Xn), torch.from_numpy(yn)))

    def test_dkl_streaming_on_featurized_inputs(self):
        X, y = toy(17, 80)
        gp = DKLExactGP(hidden=(8, 2), settings=BBMMSettings(num_probes=4, max_cg_iters=30),
                        device="cpu")
        session = PosteriorSession(gp, gp.init_params(X), X, y)
        assert session.observe(X[:2] * 0.9, y[:2]) == "append"
        mean, var = session.query(X[:7])
        assert bool(torch.all(torch.isfinite(mean))) and bool(torch.all(var > 0))

    def test_ski_session_rebuilds_on_every_observe(self, monkeypatch):
        """SKI has no update_cache: each observe re-runs prepare_inputs on the
        grown X (the grid is re-fitted) and rebuilds, and the state is
        stamped with the full fingerprint — the reference session's."""
        X, y = toy(19, 100)
        Xn = np.array([[-1.4], [1.3]], np.float32)  # beyond the training range
        yn = np.sin(4.0 * Xn[:, 0])
        rp = RefSKI(grid_size=24).init_params(jnp.asarray(X))
        params = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu", model="ski")
        model = SKI(grid_size=24, settings=BBMMSettings(num_probes=4, max_cg_iters=20),
                    device="cpu")
        session = PosteriorSession(model, params, X, y)
        assert not session.streaming
        counter = _CGCounter(monkeypatch)
        for k in range(2):
            assert session.observe(Xn[k:k + 1], yn[k:k + 1]) == "rebuild"
        assert counter.calls == 2 and session.cache_info.staleness == 0
        assert session.n == 102 and not session.stale()
        assert float(session._data["grid"].mins[0]) < float(model.prepare(X)["grid"].mins[0])
        mean, var = session.query(X[:5])
        assert bool(torch.all(torch.isfinite(mean))) and bool(torch.all(var > 0))
        # the reference's observe stamps fingerprint((params, X_full, y_full))
        X_full = np.concatenate([X, Xn])
        assert session.cache_info.fingerprint == ref_fingerprint(
            (rp, jnp.asarray(X_full), jnp.asarray(np.concatenate([y, yn]).astype(np.float32))))

    def test_fingerprint_hashes_a_network_as_the_reference_does(self):
        """A DKL parameter dict (its net a list of {"w", "b"} dicts) digests
        to the reference's fingerprint of the same arrays; a changed weight
        changes it."""
        X, y = toy(18, 30)
        rp = RefDKL(hidden=(8, 2)).init_params(X)
        params = params_from_jax(jax.tree.map(np.asarray, rp), device="cpu", model="dkl")
        fp = fingerprint((params, torch.from_numpy(X), torch.from_numpy(y)))
        assert fp == ref_fingerprint((rp, jnp.asarray(X), jnp.asarray(y)))
        params["net"][1]["w"] = params["net"][1]["w"] + 1e-3
        assert fingerprint((params, torch.from_numpy(X), torch.from_numpy(y))) != fp


class TestServeDriver:
    @pytest.mark.parametrize("model", ["sgpr", "blr", "dkl", "multitask", "ski"])
    def test_sequential_smoke(self, model, capsys):
        metrics = gp_serve.main(["--device", "cpu", "--model", model, "--n", "120",
                                 "--requests", "4", "--batch", "16", "--observe-every", "2",
                                 "--observe-batch", "3"])
        rows = 120 * (2 if model == "multitask" else 1)
        assert metrics["model"] == f"serve_{model}"
        # SKI is rebuild-only: each observe is a rebuild
        paths = (metrics["num_appends"], metrics["num_rebuilds"])
        assert paths == ((0, 2) if model == "ski" else (2, 0)) and metrics["cached_qps"] > 0
        assert metrics["final_n"] == rows + 2 * 3 * (2 if model == "multitask" else 1)
        assert "CG-free" in capsys.readouterr().out

    @pytest.mark.parametrize("model", ["sgpr", "blr", "dkl", "multitask", "ski"])
    def test_threaded_smoke(self, model, capsys):
        metrics = gp_serve.main(["--device", "cpu", "--model", model, "--n", "100",
                                 "--requests", "6", "--batch", "16", "--observe-every", "3",
                                 "--threads", "3", "--num-tasks", "3"])
        total = metrics["async_refreshes_swapped"] + metrics["async_refreshes_discarded"]
        # a double-buffered refresh follows each append; SKI's observes
        # rebuild in place (a query that meets the stale state may rebuild
        # first) and schedule none
        assert total == (0 if model == "ski" else 2) and metrics["concurrent_qps"] > 0
        tasks = 3 if model == "multitask" else 1
        assert metrics["final_n"] == (100 + 2) * tasks
        if model == "ski":
            assert metrics["cache_version"] >= 3 and metrics["cache_staleness"] == 0
        assert "double-buffered" in capsys.readouterr().out

    def test_default_model_is_sgpr(self):
        metrics = gp_serve.main(["--device", "cpu", "--n", "60", "--requests", "2",
                                 "--batch", "8", "--observe-every", "1"])
        assert metrics["model"] == "serve_sgpr"
        assert isinstance(gp_serve.build_model("sgpr", device="cpu"), SGPR)

    def test_build_model_settings(self):
        sgpr = gp_serve.build_model("sgpr", device="cpu")
        assert sgpr.num_inducing == 64 and sgpr.settings.precond_rank == 1
        dkl = gp_serve.build_model("dkl", max_cg_iters=7, device="cpu")
        assert dkl.hidden == (16, 2) and dkl.settings.max_cg_iters == 7
        mt = gp_serve.build_model("multitask", num_tasks=4, precision="mixed", device="cpu")
        assert (mt.mode, mt.num_tasks, mt.settings.precond_rank) == ("cuda", 4, 0)
        assert mt.settings.precision == "mixed"
        ski = gp_serve.build_model("ski", max_cg_iters=9, precision="mixed", device="cpu")
        assert isinstance(ski, SKI) and ski.grid_size == 64
        assert (ski.settings.num_probes, ski.settings.max_cg_iters) == (8, 9)
        assert ski.settings.precision == "mixed"
        with pytest.raises(ValueError, match="unknown model"):
            gp_serve.build_model("svgp", device="cpu")

    def test_multitask_driver_data_are_long_format(self):
        X, y = gp_serve._toy(0, 5, 2, 3)
        assert X.shape == (15, 3) and y.shape == (15,)
        np.testing.assert_array_equal(X[:, -1], np.tile(np.arange(3), 5))
        q = gp_serve._query_batch(0, 1, 8, 2, 3)
        assert q.shape == (8, 3) and set(q[:, -1]) <= {0.0, 1.0, 2.0}
        Xn, yn = gp_serve._observation(0, 1, 2, 2, 3)
        assert Xn.shape == (6, 3) and yn.shape == (6,)
        # the single-output data are the same draws as before the multitask
        # branch existed
        X1, y1 = gp_serve._toy(0, 5, 2)
        rng = np.random.default_rng([0, 0])
        np.testing.assert_array_equal(X1, rng.uniform(-1, 1, (5, 2)).astype(np.float32))

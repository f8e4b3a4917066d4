"""The port's serving layer against the reference's: ``PosteriorSession``
(fingerprints, versioning, streaming appends, double buffering), the
streaming cache update (``extend_posterior_cache``, ``_compact_basis``),
the ``gp_serve`` driver on the CPU, and the thread safety of the kernel
builds and launch counters (counterpart of tests/test_serving.py).

Port-vs-reference comparisons feed both packages the same numpy data and
the reference's probes (``IdentityPreconditioner.sample_probes`` with
``PRNGKey(0)``, injected into the port as tests/test_torch_exact_serving.py
does); at (num_probes + 1)·(max_cg_iters + 1) ≥ n the Krylov basis spans
ℝⁿ, so both caches serve the exact variance.  Tolerances: means rtol 1e-3 /
atol 1e-4, variances rtol 5e-3 / atol 1e-4 (tests/test_posterior_cache.py:
44,65); a streamed mean against a rebuild's rtol / atol 1e-4 and the
variance conservative to 1e-3 (tests/test_serving.py:264,276).  Every
thread is joined with a timeout.
"""

import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core.preconditioner as port_precond
from repro.core.inference import _compact_basis as ref_compact_basis
from repro.gp import ExactGP as RefExactGP
from repro.serving import fingerprint as ref_fingerprint
from repro_torch import ExactGP, NoCudaDeviceError, params_from_jax
from repro_torch.core import BBMMSettings, SolveHealthWarning, cached_inv_quad
from repro_torch.core.inference import PosteriorCache, _compact_basis
from repro_torch.gp import PROTOCOL_METHODS, missing_protocol_methods, supports_streaming
from repro_torch.kernels import build
from repro_torch.kernels.kernel_matmul import kernel_matmul as km
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

MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=5e-3, atol=1e-4)
STREAM_TOL = dict(rtol=1e-4, atol=1e-4)
JOIN_S = 60.0


def _toy(seed, n, d=1, noise=0.05):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, d)).astype(np.float32)
    y = (np.sin(4 * X[:, 0]) + noise * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _gp(**settings):
    s = dict(num_probes=6, max_cg_iters=30)
    s.update(settings)
    return ExactGP(mode="cuda", device="cpu", settings=BBMMSettings(**s))


def _session(n=60, **kw):
    X, y = _toy(7, n)
    gp = _gp()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SolveHealthWarning)
        return PosteriorSession(gp, gp.init_params(X), X, y, **kw), X, y


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SolveHealthWarning)
        warnings.simplefilter("ignore", ref_core.SolveHealthWarning)
        yield


class TestFingerprint:
    def test_digest_equals_the_reference(self):
        rng = np.random.default_rng(0)
        params = {"raw_noise": np.float32(0.1), "raw_lengthscale": rng.standard_normal(3)
                  .astype(np.float32), "raw_outputscale": np.float32(-0.2)}
        X = rng.standard_normal((17, 3)).astype(np.float32)
        y = rng.standard_normal(17).astype(np.float32)
        ref = ref_fingerprint(({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(X), jnp.asarray(y)))
        port = fingerprint(({k: torch.as_tensor(v) for k, v in params.items()},
                            torch.from_numpy(X), torch.from_numpy(y)))
        assert port == ref
        assert fingerprint(({k: np.asarray(v) for k, v in params.items()}, X, y)) == ref
        y[0] += 1e-6
        assert fingerprint(({k: torch.as_tensor(v) for k, v in params.items()},
                            torch.from_numpy(X), torch.from_numpy(y))) != ref


class TestProtocol:
    def test_exact_gp_conforms_and_streams(self):
        gp = _gp()
        assert missing_protocol_methods(gp) == []
        assert all(callable(getattr(gp, m)) for m in PROTOCOL_METHODS)
        assert supports_streaming(gp)


class TestSessionVersioning:
    def test_build_and_query(self):
        session, X, _ = _session()
        info = session.cache_info
        assert (info.version, info.staleness, info.n) == (1, 0, 60)
        mean, var = session.query(X[:5])
        assert mean.shape == (5,) and bool((var > 0).all()) and not session.stale()

    def test_params_change_invalidates(self):
        session, X, _ = _session()
        v0, fp0 = session.cache_info.version, session.cache_info.fingerprint
        session.update_params({k: v + 0.1 for k, v in session.params.items()})
        assert session.stale()
        session.query(X[:3])  # rebuilds lazily
        assert not session.stale()
        assert session.cache_info.version > v0 and session.cache_info.fingerprint != fp0

    def test_data_change_bumps_version_and_fingerprint(self):
        session, X, y = _session()
        fp0 = session.cache_info.fingerprint
        assert fp0 == fingerprint((session.params, torch.from_numpy(X), torch.from_numpy(y)))
        assert session.observe(X[:1] * 0.5, y[:1] * 0.5) == "append"
        assert session.cache_info.fingerprint != fp0
        assert session.cache_info.n == 61 and not session.stale()

    def test_max_staleness_forces_rebuild(self):
        session, X, y = _session(max_staleness=2)
        paths = [session.observe(X[:1] + 0.01 * i, y[:1]) for i in range(3)]
        assert paths == ["append", "append", "rebuild"]
        assert session.cache_info.staleness == 0

    def test_max_staleness_zero_disables_streaming(self):
        session, X, y = _session(max_staleness=0)
        assert session.observe(X[:1], y[:1]) == "rebuild"

    def test_refresh_if_stale_hook(self):
        session, X, y = _session()
        assert not session.refresh_if_stale()
        session.observe(X[:1], y[:1])
        v = session.cache_info.version
        assert session.refresh_if_stale()
        assert (session.cache_info.staleness, session.cache_info.version) == (0, v + 1)
        assert not session.refresh_if_stale()

    def test_rejects_non_protocol_model(self):
        with pytest.raises(TypeError, match="GPModel"):
            PosteriorSession(object(), {}, np.zeros((4, 1)), np.zeros(4))

    def test_cache_is_built_outside_autograd(self):
        """no_grad, not inference_mode: the cache's tensors carry no graph
        and can meet autograd later."""
        session, X, _ = _session()
        assert not session.cache.alpha.requires_grad
        assert not torch.is_inference(session.cache.alpha)
        w = torch.ones_like(session.cache.alpha, requires_grad=True)
        (w * session.cache.alpha).sum().backward()
        assert w.grad is not None


def _reference_probes(t, n):
    return np.array(ref_core.IdentityPreconditioner().sample_probes(jax.random.PRNGKey(0), t, n))


class TestStreamingAgainstTheReference:
    """extend_posterior_cache (and its compaction) on the same inputs and
    probes as the reference's."""

    N, NEW, S = 100, 6, 25

    def _both(self, monkeypatch, max_basis_columns=0):
        settings = dict(num_probes=4, max_cg_iters=40, cg_tol=1e-8, precond_rank=0,
                        max_basis_columns=max_basis_columns)
        X, y = _toy(13, self.N)
        Xn, yn = _toy(14, self.NEW)
        Xs = np.linspace(-0.9, 0.9, self.S, dtype=np.float32)[:, None]
        Z = _reference_probes(settings["num_probes"], self.N)
        monkeypatch.setattr(port_precond.IdentityPreconditioner, "sample_probes",
                            lambda self_, g, num, n: torch.from_numpy(Z))
        ref_gp = RefExactGP(settings=ref_core.BBMMSettings(**settings))
        ref_params = ref_gp.init_params(X)
        params = params_from_jax({k: np.asarray(v) for k, v in ref_params.items()}, device="cpu")
        gp = ExactGP(mode="cuda", device="cpu", settings=BBMMSettings(**settings))
        Xf, yf = np.concatenate([X, Xn]), np.concatenate([y, yn])
        out = {}
        rc = ref_gp.posterior_cache(ref_params, jnp.asarray(X), jnp.asarray(y))
        rc2 = ref_gp.update_cache(ref_params, jnp.asarray(Xf), jnp.asarray(yf), rc,
                                  jnp.asarray(Xn), jnp.asarray(yn))
        out["ref"] = (rc2, [np.asarray(a) for a in ref_gp.predict_cached(
            ref_params, jnp.asarray(Xf), rc2, jnp.asarray(Xs))])
        pc = gp.posterior_cache(params, X, y)
        pc2 = gp.update_cache(params, Xf, yf, pc, Xn, yn)
        out["port"] = (pc2, [a.numpy() for a in gp.predict_cached(params, Xf, pc2, Xs)])
        kern = gp.kernel(params)
        Xf64, Xs64 = torch.from_numpy(Xf).double(), torch.from_numpy(Xs).double()
        noise = float(gp.noise(params))
        K = kern(Xf64, Xf64) + noise * torch.eye(Xf.shape[0], dtype=torch.float64)
        Kxs = kern(Xf64, Xs64)
        exact_var = (kern.diag(Xs64) - (Kxs * torch.linalg.solve(K, Kxs)).sum(0) + noise).numpy()
        return out, exact_var

    def test_extend_matches_the_reference_and_stays_conservative(self, monkeypatch):
        out, exact_var = self._both(monkeypatch)
        (rc, (rmean, rvar)), (pc, (mean, var)) = out["ref"], out["port"]
        assert pc.basis.shape == rc.basis.shape
        assert int(pc.cg_iters.max()) == int(np.asarray(rc.cg_iters).max())
        np.testing.assert_allclose(pc.alpha.numpy(), np.asarray(rc.alpha), **MEAN_TOL)
        np.testing.assert_allclose(mean, rmean, **MEAN_TOL)
        np.testing.assert_allclose(var, rvar, **VAR_TOL)
        assert (var >= exact_var - 1e-3).all()

    def test_compacted_extend_matches_the_reference(self, monkeypatch):
        out, exact_var = self._both(monkeypatch, max_basis_columns=40)
        (rc, (rmean, rvar)), (pc, (mean, var)) = out["ref"], out["port"]
        assert pc.basis.shape == rc.basis.shape == (self.N + self.NEW, 40)
        np.testing.assert_allclose(mean, rmean, **MEAN_TOL)
        np.testing.assert_allclose(var, rvar, **VAR_TOL)
        assert (var >= exact_var - 1e-3).all()

    def test_compact_basis_matches_the_reference(self):
        rng = np.random.default_rng(5)
        n, m, keep = 30, 12, 5
        Q = np.linalg.qr(rng.standard_normal((n, m)))[0].astype(np.float32)
        W = rng.standard_normal((m, m))
        G = (W @ W.T + m * np.eye(m)).astype(np.float32)
        rb, rl = ref_compact_basis(jnp.asarray(Q), jnp.asarray(G), keep)
        pb, pl = _compact_basis(torch.from_numpy(Q), torch.from_numpy(G), keep)
        # eigenvectors carry a sign of their own: compare what is invariant
        np.testing.assert_allclose(np.diag(pl.numpy()), np.diag(np.asarray(rl)), rtol=1e-5)
        V = rng.standard_normal((n, 7)).astype(np.float32)
        rq = cached_inv_quad(PosteriorCache(None, torch.from_numpy(np.asarray(rb)),
                                            torch.from_numpy(np.asarray(rl)), *([None] * 6)),
                             torch.from_numpy(V))
        pq = cached_inv_quad(PosteriorCache(None, pb, pl, *([None] * 6)), torch.from_numpy(V))
        np.testing.assert_allclose(pq.numpy(), rq.numpy(), rtol=1e-4, atol=1e-6)
        # a non-finite Gram gives NaN without raising, as the reference's
        bad = torch.from_numpy(G).clone()
        bad[0, 0] = float("nan")
        nb, nl = _compact_basis(torch.from_numpy(Q), bad, keep)
        assert bool(torch.isnan(nb).all()) and bool(torch.isnan(torch.diag(nl)).all())

    def test_streamed_session_matches_a_rebuild(self):
        """The streamed mean within CG tolerance of a from-scratch rebuild,
        the recycled variance conservative against the exact posterior
        (tests/test_serving.py:238-276)."""
        gp = _gp(max_cg_iters=60, cg_tol=1e-8)
        X, y = _toy(13, 100)
        Xn, yn = _toy(14, 6)
        Xs = np.linspace(-0.9, 0.9, 25, dtype=np.float32)[:, None]
        params = gp.init_params(X)
        session = PosteriorSession(gp, params, X, y)
        assert session.observe(Xn, yn) == "append"
        mean_s, var_s = session.query(Xs)
        Xf, yf = np.concatenate([X, Xn]), np.concatenate([y, yn])
        mean_r, _ = PosteriorSession(gp, params, Xf, yf).query(Xs)
        np.testing.assert_allclose(mean_s.numpy(), mean_r.numpy(), **STREAM_TOL)
        kern, noise = gp.kernel(params), gp.noise(params)
        Xf_t, Xs_t = torch.from_numpy(Xf), torch.from_numpy(Xs)
        Kd = kern(Xf_t, Xf_t) + noise * torch.eye(Xf.shape[0])
        Kxs = kern(Xf_t, Xs_t)
        exact = kern.diag(Xs_t) - (Kxs * torch.linalg.solve(Kd, Kxs)).sum(0) + noise
        assert bool((var_s >= exact - 1e-3).all())

    def test_new_directions_drop_what_adds_nothing(self):
        """A zero column and a column inside the recycled span add no
        direction; the rest come back orthonormal and orthogonal to it; a
        non-finite block comes back NaN."""
        from repro_torch.core.inference import _new_directions

        gen = torch.Generator().manual_seed(0)
        B = torch.linalg.qr(torch.randn(50, 10, generator=gen))[0]
        F = torch.randn(50, 6, generator=gen)
        F[:, 3] = 0.0
        F[:, 4] = 2.0 * B[:, 0] - B[:, 7]
        N = _new_directions(F, B, 5)
        assert N.shape == (50, 4)
        full = torch.cat([B, N], dim=1)
        torch.testing.assert_close(full.T @ full, torch.eye(14), rtol=0, atol=1e-5)
        kept = [0, 1, 2, 5]  # their span is kept: the projection of F onto it
        P = F[:, kept] - B @ (B.T @ F[:, kept])
        torch.testing.assert_close(N @ (N.T @ P), P, rtol=0, atol=1e-5)
        assert _new_directions(F, B, 2).shape == (50, 2)
        F[0, 0] = float("nan")
        assert bool(torch.isnan(_new_directions(F, B, 5)).all())

    def test_appends_after_early_convergence_keep_an_orthonormal_basis(self):
        """When an append's CG converges before max_cg_iters, its zero
        Lanczos columns add no direction.  The reference's QR turns them into
        arbitrary unit vectors inside the recycled span, and after the second
        such append its Gram is singular and it serves NaN variances (ROADMAP
        Queue C); the port keeps only new directions: its basis stays
        orthonormal and its variance finite and conservative."""
        from repro.serving import PosteriorSession as RefPosteriorSession
        from repro_torch.launch import gp_serve

        X, y = gp_serve._toy(0, 300, 8)
        settings = dict(num_probes=8, max_cg_iters=25, max_basis_columns=256)
        gp = ExactGP(mode="cuda", kernel_type="rbf", device="cpu",
                     settings=BBMMSettings(**settings))
        ref_gp = RefExactGP(settings=ref_core.BBMMSettings(**settings))
        session = PosteriorSession(gp, gp.init_params(X), X, y)
        ref = RefPosteriorSession(ref_gp, ref_gp.init_params(jnp.asarray(X)), jnp.asarray(X),
                                  jnp.asarray(y))
        for r in range(2):
            Xn, yn = gp_serve._observation(0, r, 64, 8)
            assert session.observe(Xn, yn) == ref.observe(jnp.asarray(Xn), jnp.asarray(yn))
            assert int(session.cache.cg_iters.max()) < 25  # converged early
            B = session.cache.basis
            torch.testing.assert_close(B.T @ B, torch.eye(B.shape[1]), rtol=0, atol=1e-4)
        Xs = X[:16] + 0.05
        _, var = session.query(Xs)
        assert bool(np.isnan(np.asarray(ref.query(jnp.asarray(Xs))[1])).all())
        kern, noise = gp.kernel(session.params), gp.noise(session.params)
        K = kern(session.X, session.X) + noise * torch.eye(session.n)
        Kxs = kern(session.X, torch.from_numpy(Xs))
        exact = kern.diag(torch.from_numpy(Xs)) - (Kxs * torch.linalg.solve(K, Kxs)).sum(0) + noise
        assert bool(torch.isfinite(var).all()) and bool((var >= exact - 1e-3).all())

    def test_append_issues_fewer_cg_iterations(self):
        gp = _gp(max_cg_iters=40)
        X, y = _toy(15, 120)
        Xn, yn = _toy(16, 4)
        session = PosteriorSession(gp, gp.init_params(X), X, y)
        build_iters = int(session.cache.cg_iters.max())
        session.observe(Xn, yn)
        assert int(session.cache.cg_iters.max()) < build_iters


class _Gated:
    """Delegates to a model; ``posterior_cache`` / ``update_cache`` wait
    for ``gate`` (after setting ``started``)."""

    def __init__(self, base, methods=("posterior_cache",)):
        self._base, self._methods = base, methods
        self.started, self.gate = threading.Event(), threading.Event()
        self.builds = 0

    def __getattr__(self, name):
        attr = getattr(self._base, name)
        if name not in self._methods:
            return attr

        def gated(*a, **k):
            if name == "posterior_cache":
                self.builds += 1
            self.started.set()
            assert self.gate.wait(timeout=JOIN_S)
            return attr(*a, **k)

        return gated


class TestDoubleBufferedCache:
    def test_inline_refresh_swaps_on_match(self):
        session, _, _ = _session()
        v0 = session.cache_info.version
        info = session.rebuild_async()
        assert info is not None and info.version == v0 + 1 and info.staleness == 0
        assert session.cache_info is info

    def test_stale_buffer_is_discarded(self):
        session, X, y = _session()
        real = session.model
        gated = _Gated(real)
        session.model = gated
        with ThreadPoolExecutor(1) as pool:
            fut = session.rebuild_async(pool)
            assert gated.started.wait(timeout=JOIN_S)
            session.model = real  # the observe's own path runs ungated
            session.observe(X[:1] * 0.95, y[:1])
            v, fp = session.cache_info.version, session.cache_info.fingerprint
            gated.gate.set()
            assert fut.result(timeout=JOIN_S) is None  # the buffer was discarded
        assert (session.cache_info.version, session.cache_info.fingerprint) == (v, fp)
        assert not session.stale()

    def test_queries_served_while_buffer_builds(self):
        session, X, _ = _session()
        v0 = session.cache_info.version
        real = session.model
        gated = _Gated(real)
        session.model = gated
        try:
            with ThreadPoolExecutor(1) as pool:
                fut = session.rebuild_async(pool)
                assert gated.started.wait(timeout=JOIN_S)
                (mean, var), served = session.query_served(X[:5])
                assert served.info.version == session.cache_info.version == v0
                assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
                gated.gate.set()
                info = fut.result(timeout=JOIN_S)
        finally:
            session.model = real
        assert info.version == v0 + 1 and session.cache_info is info

    def test_query_serves_old_cache_during_append(self):
        session, X, y = _session()
        v0 = session.cache_info.version
        real = session.model
        gated = _Gated(real, methods=("update_cache", "posterior_cache"))
        session.model = gated
        try:
            with ThreadPoolExecutor(1) as pool:
                fut = pool.submit(session.observe, X[:1] * 0.97, y[:1])
                assert gated.started.wait(timeout=JOIN_S)
                (mean, var), served = session.query_served(X[:4])
                assert gated.builds == 0  # no duplicate build
                assert served.info.version == v0 and served.info.n == 60
                assert bool(torch.isfinite(mean).all()) and bool((var > 0).all())
                gated.gate.set()
                assert fut.result(timeout=JOIN_S) == "append"
        finally:
            session.model = real
        assert (session.cache_info.version, session.cache_info.staleness) == (v0 + 1, 1)

    def test_served_answer_replays_bit_for_bit(self):
        session, X, y = _session()
        session.observe(X[:2] * 0.9, y[:2])
        (mean, var), served = session.query_served(X[:6])
        again = session.model.predict_cached(served.params, served.data, served.cache, X[:6])
        assert torch.equal(again[0], mean) and torch.equal(again[1], var)


class TestServeDriver:
    def test_sequential_smoke(self, capsys):
        metrics = gp_serve.main(["--device", "cpu", "--model", "exact", "--n", "200",
                                 "--requests", "4", "--batch", "16", "--observe-every", "2",
                                 "--max-basis-columns", "120"])
        assert metrics["num_appends"] >= 1 and metrics["cached_qps"] > 0
        assert metrics["final_n"] > 200
        assert "CG-free" in capsys.readouterr().out

    def test_threaded_smoke(self, capsys):
        metrics = gp_serve.main(["--device", "cpu", "--model", "exact", "--n", "200",
                                 "--requests", "6", "--batch", "16", "--observe-every", "3",
                                 "--threads", "3"])
        total = metrics["async_refreshes_swapped"] + metrics["async_refreshes_discarded"]
        assert total == 2  # one double-buffered refresh per (appending) observe
        assert metrics["concurrent_qps"] > 0
        assert "double-buffered" in capsys.readouterr().out

    def test_chaos_smoke(self, capsys):
        metrics = gp_serve.main(["--device", "cpu", "--chaos", "--n", "48", "--batch", "8",
                                 "--max-cg-iters", "25"])
        assert metrics["chaos_ok"] and metrics["unhandled_exceptions"] == 0
        assert "OK" in capsys.readouterr().out

    @pytest.mark.parametrize("model", ["sgpr", "ski", "dkl", "blr", "multitask"])
    def test_unported_models_name_their_step(self, model):
        """Every model of the reference driver is ported now (ski last, with
        ROADMAP Queue A step 15b), so none raises naming a step: each serves
        and folds its observations in."""
        argv = ["--device", "cpu", "--model", model, "--n", "20", "--requests", "2",
                "--batch", "4", "--observe-every", "1"]
        assert gp_serve.main(argv)["final_n"] > 20

    def test_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(NoCudaDeviceError):
            gp_serve.main(["--n", "20", "--requests", "1"])


class TestThreadSafety:
    def test_concurrent_first_use_builds_once(self, monkeypatch, tmp_path):
        """Eight threads reach the kernels at once on a fresh process:
        one nvcc per source, one load per library (the compile step and
        the loader stubbed: no nvcc here)."""
        popens, loads = [], []
        count_lock = threading.Lock()

        class FakeProc:
            returncode = 0

            def __init__(self, cmd, **kw):
                with count_lock:
                    popens.append(cmd[-1])

            def communicate(self):
                threading.Event().wait(0.05)  # widen the race window
                return "ptxas info", None

        class FakeLib:
            def __getattr__(self, name):
                return type("Fn", (), {})()

        def fake_cdll(path):
            with count_lock:
                loads.append(path)
            threading.Event().wait(0.01)
            return FakeLib()

        monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(build.subprocess, "Popen", FakeProc)
        monkeypatch.setattr(build.ctypes, "CDLL", fake_cdll)
        monkeypatch.setattr(build, "_infos", {})
        monkeypatch.setattr(build, "_libs", {})
        barrier = threading.Barrier(8)
        errors = []

        def first_use(i):
            try:
                barrier.wait(timeout=JOIN_S)
                build.load_library(sorted(build.ENTRY_POINTS)[i % 2])
                build.build_all()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        threads = [threading.Thread(target=first_use, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not any(t.is_alive() for t in threads) and not errors
        assert sorted(popens) == sorted(str(build.source(n)) for n in build.ENTRY_POINTS)
        assert len(loads) == 2 and set(build._libs) == set(sorted(build.ENTRY_POINTS)[:2])

    def test_launch_counters_are_exact_under_threads(self):
        import sys

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        km.reset_launch_counts()
        per_thread = []
        try:
            def launch_many():
                for i in range(2000):
                    km._count("launches", panel=i % 2 == 0)
                    km._count("grad_launches", 2)
                per_thread.append(km.thread_launch_counts())

            threads = [threading.Thread(target=launch_many) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=JOIN_S)
        finally:
            sys.setswitchinterval(old)
        counts = km.launch_counts()
        km.reset_launch_counts()
        assert (counts["launches"], counts["panel_launches"], counts["grad_launches"]) == (
            8 * 2000, 8 * 1000, 8 * 4000)
        assert len(per_thread) == 8
        assert all((c["launches"], c["panel_launches"], c["grad_launches"]) == (2000, 1000, 4000)
                   for c in per_thread)

    def test_engine_qr_is_serialised_across_threads(self, monkeypatch):
        """cuSOLVER's geqrf fails when two threads call it at once (on the
        card: CUSOLVER_STATUS_INTERNAL_ERROR), so the engine's QRs take one
        lock: however many threads factor, one QR runs at a time."""
        from repro_torch.core import inference

        real, active, peak = torch.linalg.qr, [0], [0]
        lock = threading.Lock()

        def tracking_qr(A, *a, **k):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            threading.Event().wait(0.01)
            with lock:
                active[0] -= 1
            return real(A, *a, **k)

        monkeypatch.setattr(torch.linalg, "qr", tracking_qr)
        A = torch.randn(50, 6)
        with ThreadPoolExecutor(6) as pool:
            outs = list(pool.map(lambda _: inference._qr(A), range(24), timeout=JOIN_S))
        assert peak[0] == 1
        assert all(torch.equal(o, outs[0]) for o in outs)

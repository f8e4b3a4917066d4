"""The port's solve health against the reference's: the degradation ladder,
``dense_direct_max_n``, fault injection, the circuit breaker and the
hardened serving session (counterpart of tests/test_health.py).

The same numpy system — tests/test_health.py's ``system``, a 48×48 SPD
QQᵀ plus σ² = 0.1 — goes through ``repro.core.solve`` and
``repro_torch.core.solve`` with a :class:`FaultSchedule` of the same seed
on each side; rung sequences and statuses must be the reference's, and
every healed answer must solve the clean system to the reference's 1e-3
(tests/test_health.py:225) and agree with the reference's at rtol 1e-3 /
atol 1e-4 (tests/test_posterior_cache.py:44).  The port runs on the CPU.
"""

import dataclasses
import itertools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core.inference import _escalation_ladder as ref_escalation_ladder
from repro.launch.gp_serve import _ChaosModel as RefChaosModel
from repro.gp import ExactGP as RefExactGP
from repro.serving import CircuitBreaker as RefCircuitBreaker
from repro.serving import PosteriorSession as RefPosteriorSession
from repro_torch import ExactGP
from repro_torch.core import (
    AddedDiagOperator,
    BBMMSettings,
    DenseOperator,
    FaultInjectingOperator,
    FaultSchedule,
    SolveFailure,
    SolveHealthWarning,
    collect,
    solve,
)
from repro_torch.core import health
from repro_torch.core.inference import _escalation_ladder
from repro_torch.launch.gp_serve import _ChaosModel, run_serve_chaos
from repro_torch.serving import CircuitBreaker, PosteriorSession, QueryDeadlineExceeded

jax.config.update("jax_platform_name", "cpu")

pytestmark = pytest.mark.robust

N = 48
HEAL_RES = 1e-3  # tests/test_health.py:225
X_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_posterior_cache.py:44


@pytest.fixture(scope="module")
def system():
    """tests/test_health.py's system, as numpy arrays."""
    key = jax.random.PRNGKey(0)
    Q = jax.random.normal(key, (N, N)) / jnp.sqrt(N)
    A = Q @ Q.T
    b = jax.random.normal(jax.random.fold_in(key, 1), (N,))
    return np.asarray(A), np.asarray(b)


def _ops(A, make_schedule, negative_diag=0.0, sigma2=0.1):
    """(reference operator, port operator), each with its own schedule from
    ``make_schedule(FaultSchedule class)``."""
    ref = ref_core.AddedDiagOperator(
        ref_core.FaultInjectingOperator(ref_core.DenseOperator(jnp.asarray(A)),
                                        schedule=make_schedule(ref_core.FaultSchedule),
                                        negative_diag=negative_diag),
        jnp.float32(sigma2),
    )
    port = AddedDiagOperator(
        FaultInjectingOperator(DenseOperator(torch.tensor(A)),
                               schedule=make_schedule(FaultSchedule),
                               negative_diag=negative_diag),
        torch.tensor(sigma2),
    )
    return ref, port


def _solve_both(A, b, make_schedule, settings: dict, **op_kw):
    """Solve on both sides under collectors: ((ref report, ref x, ref
    schedule), (port report, port x, port schedule)); warnings silenced."""
    ref_op, port_op = _ops(A, make_schedule, **op_kw)
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ref_core.SolveHealthWarning)
        warnings.simplefilter("ignore", SolveHealthWarning)
        with ref_core.collect() as reports:
            x = ref_core.solve(ref_op, jnp.asarray(b), ref_core.BBMMSettings(**settings))
        out.append((reports[-1], np.asarray(x), ref_op.base.schedule))
        with collect() as reports:
            x = solve(port_op, torch.tensor(b), BBMMSettings(**settings))
        out.append((reports[-1], x.numpy(), port_op.base.schedule))
    return out


def _trail(report):
    return [(r.rung, r.status) for r in report.rungs]


def _clean_residual(A, b, x):
    K = A.astype(np.float64) + 0.1 * np.eye(N)
    return np.linalg.norm(K @ x - b) / np.linalg.norm(b)


MIXED = dict(num_probes=4, max_cg_iters=8, cg_tol=1e-6, precond_rank=0, precision="mixed",
             cg_refresh_every=2)
HIGHEST = dict(num_probes=4, max_cg_iters=10, cg_tol=1e-6, precond_rank=0)


class TestFaultSchedule:
    @pytest.mark.parametrize("kw", [
        dict(nan_rate=0.3),
        dict(nan_rate=0.5, reduced_only=True),
        dict(nan_calls=(1, 4), inf_calls=(2,)),
        dict(total_outage=True),
    ], ids=["rate", "reduced_only", "calls", "outage"])
    def test_same_seed_gives_the_reference_codes(self, kw):
        reduced = [bool(i % 3) for i in range(40)]
        ref, port = ref_core.FaultSchedule(7, **kw), FaultSchedule(7, **kw)
        codes = [(ref.next_code(r), port.next_code(r)) for r in reduced]
        assert [c[0] for c in codes] == [c[1] for c in codes]
        assert ref.injected == port.injected and ref.calls == port.calls == 40

    @pytest.mark.parametrize("settings", [MIXED, dict(MIXED, fuse_cg=True), HIGHEST],
                             ids=["mixed", "mixed_fused", "highest"])
    def test_a_solve_ticks_as_the_reference(self, system, settings):
        """One tick per matmul or fused step of the same loop: the seeded
        schedule delivers the reference's (call, code) list."""
        A, b = system
        (_, _, ref_s), (_, _, port_s) = _solve_both(
            A, b, lambda cls: cls(7, nan_rate=0.3), settings)
        assert port_s.calls == ref_s.calls
        assert port_s.injected == ref_s.injected and port_s.injected

    def test_corruption_lands_on_the_scheduled_rows(self):
        M = torch.ones(6, 2)
        for panel, rows in ((None, [0]), ((2, 3), [2, 3, 4])):
            op = FaultInjectingOperator(DenseOperator(torch.eye(6)),
                                        schedule=FaultSchedule(0, nan_calls=(0,), panel=panel))
            out = op.matmul(M)
            bad = sorted(set(torch.nonzero(~torch.isfinite(out))[:, 0].tolist()))
            assert bad == rows
            assert torch.equal(op.matmul(M), M)  # call 1 is clean

    def test_fused_step_corruption_poisons_v_rows_and_reductions(self):
        """The fused seam: the scheduled rows of V′ and every (4, t)
        reduction go bad on a faulted call; U′, R′, D′ and other calls stay
        the base step's."""
        from repro_torch.gp import KernelOperator, RBFKernel

        rng = np.random.default_rng(0)
        X = torch.from_numpy(rng.uniform(-1, 1, (20, 2)).astype(np.float32))
        kern = RBFKernel(lengthscale=torch.tensor(0.5), outputscale=torch.tensor(1.0))
        base = KernelOperator(kernel=kern, X=X, mode="cuda")
        sched = FaultSchedule(0, nan_calls=(1,), panel=(4, 2))
        op = AddedDiagOperator(FaultInjectingOperator(base, schedule=sched), torch.tensor(0.1))
        step = op.prepare().fused_cg_step_fn()
        clean = AddedDiagOperator(base, torch.tensor(0.1)).prepare().fused_cg_step_fn()
        state = [torch.from_numpy(rng.standard_normal((20, 3)).astype(np.float32))
                 for _ in range(4)]
        scal = [torch.full((3,), v) for v in (0.1, 0.2, 1.0)]
        for call in range(2):
            *got, red = step(*state, *scal)
            *want, red_w = clean(*state, *scal)
            assert all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
            if call == 0:
                assert torch.equal(got[3], want[3])
                assert all(torch.equal(r, w) for r, w in zip(red, red_w))
            else:
                bad = sorted(set(torch.nonzero(~torch.isfinite(got[3]))[:, 0].tolist()))
                assert bad == [4, 5]
                assert all(bool(torch.isnan(r).all()) for r in red)
        assert sched.injected == [(1, FaultSchedule.NAN)]


class TestTaxonomyParity:
    """Each failure class through a real solve, on both sides."""

    @pytest.mark.parametrize("case", ["converged", "max_iters", "outage", "rescued", "stalled",
                                      "diverged"])
    def test_status_matches_the_reference(self, system, case):
        A, b = system
        make, settings, kw = {
            "converged": (lambda c: c(0), dict(num_probes=4, max_cg_iters=60, cg_tol=1e-4), {}),
            "max_iters": (lambda c: c(0), dict(num_probes=4, max_cg_iters=2, cg_tol=1e-10), {}),
            "outage": (lambda c: c(0, total_outage=True), HIGHEST, {}),
            "rescued": (lambda c: c(0, inf_calls=(2,)), MIXED, {}),
            "stalled": (lambda c: c(0, inf_calls=(4,)), MIXED, {}),
            "diverged": (lambda c: c(0), HIGHEST, dict(negative_diag=0.3)),
        }[case]
        (ref_rep, ref_x, _), (rep, x, sched) = _solve_both(A, b, make, settings, **kw)
        expect = {"converged": health.CONVERGED, "max_iters": health.MAX_ITERS,
                  "outage": health.NON_FINITE, "rescued": health.RESCUED,
                  "stalled": health.STALLED, "diverged": health.DIVERGED}[case]
        assert ref_rep.status == expect
        assert rep.status == expect
        assert (rep.num_iters, rep.max_iters) == (ref_rep.num_iters, ref_rep.max_iters)
        assert rep.num_rescues == ref_rep.num_rescues
        assert rep.num_curvature_skips == ref_rep.num_curvature_skips
        assert np.isfinite(x).all() == np.isfinite(ref_x).all()


class TestLadderParity:
    def test_escalation_ladder_matches_the_reference_over_a_grid(self):
        grid = itertools.product(("highest", "mixed"), (False, True), (0, 5), (4, 25))
        for precision, fuse, rank, iters in grid:
            kw = dict(precision=precision, fuse_cg=fuse, precond_rank=rank, max_cg_iters=iters)
            ref = ref_escalation_ladder(ref_core.BBMMSettings(**kw))
            port = _escalation_ladder(BBMMSettings(**kw))
            assert [n for n, _ in port] == [n for n, _ in ref], kw
            for (_, s), (_, r) in zip(port, ref):
                assert dataclasses.asdict(s) == dataclasses.asdict(r), kw

    @pytest.mark.parametrize("scenario", [
        "precision_heals", "every_rung_dense_heals", "noop_rungs_skipped",
    ])
    def test_healed_trail_matches_the_reference(self, system, scenario):
        A, b = system
        make, settings = {
            "precision_heals": (
                lambda c: c(0, nan_rate=1.0, reduced_only=True),
                dict(num_probes=4, max_cg_iters=60, cg_tol=1e-4, precond_rank=0,
                     precision="mixed", on_failure="degrade")),
            "every_rung_dense_heals": (
                lambda c: c(0, nan_rate=1.0),
                dict(num_probes=4, max_cg_iters=4, cg_tol=1e-6, precond_rank=0,
                     precision="mixed", fuse_cg=True, on_failure="degrade")),
            "noop_rungs_skipped": (
                lambda c: c(0, nan_rate=1.0),
                dict(num_probes=4, max_cg_iters=4, cg_tol=1e-6, precond_rank=0,
                     on_failure="degrade")),
        }[scenario]
        (ref_rep, ref_x, _), (rep, x, _) = _solve_both(A, b, make, settings)
        expect = {
            "precision_heals": ["initial", "precision_f32"],
            "every_rung_dense_heals": ["initial", "precision_f32", "unfused", "extend_budget",
                                       "dense_cholesky"],
            "noop_rungs_skipped": ["initial", "extend_budget", "dense_cholesky"],
        }[scenario]
        assert [r for r, _ in _trail(ref_rep)] == expect
        assert _trail(rep) == _trail(ref_rep)
        assert rep.status == ref_rep.status == health.CONVERGED and rep.degraded
        assert all(r.duration_s is not None for r in rep.rungs)
        assert _clean_residual(A, b, x) < HEAL_RES
        np.testing.assert_allclose(x, ref_x, **X_TOL)

    def test_ladder_exhausted_raises_as_the_reference(self, system):
        A, b = system
        settings = dict(num_probes=4, max_cg_iters=4, cg_tol=1e-6, precond_rank=0,
                        on_failure="degrade")
        ref_op, port_op = _ops(A, lambda c: c(0, total_outage=True))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ref_core.SolveFailure) as ref_err:
                ref_core.solve(ref_op, jnp.asarray(b), ref_core.BBMMSettings(**settings))
            with pytest.raises(SolveFailure) as err:
                solve(port_op, torch.tensor(b), BBMMSettings(**settings))
        trail = _trail(err.value.report)
        assert trail == _trail(ref_err.value.report)
        assert trail[0][0] == "initial" and trail[-1] == ("dense_cholesky", None)
        assert "not positive definite" in err.value.report.rungs[-1].error

    def test_on_failure_raise(self, system):
        A, b = system
        _, op = _ops(A, lambda c: c(0, total_outage=True))
        with pytest.raises(SolveFailure):
            solve(op, torch.tensor(b),
                  BBMMSettings(num_probes=4, max_cg_iters=4, precond_rank=0, on_failure="raise"))

    @pytest.mark.parametrize("max_n", [N - 1, N], ids=["below", "at"])
    def test_dense_fallback_gated_by_n(self, system, max_n):
        A, b = system
        settings = dict(num_probes=4, max_cg_iters=4, precond_rank=0, on_failure="degrade",
                        dense_fallback_max_n=max_n)
        if max_n < N:
            ref_op, port_op = _ops(A, lambda c: c(0, nan_rate=1.0))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with pytest.raises(ref_core.SolveFailure):
                    ref_core.solve(ref_op, jnp.asarray(b), ref_core.BBMMSettings(**settings))
                with pytest.raises(SolveFailure) as err:
                    solve(port_op, torch.tensor(b), BBMMSettings(**settings))
            assert [r.rung for r in err.value.report.rungs] == ["initial", "extend_budget"]
        else:
            (ref_rep, _, _), (rep, x, _) = _solve_both(
                A, b, lambda c: c(0, nan_rate=1.0), settings)
            assert _trail(rep) == _trail(ref_rep)
            assert rep.rungs[-1].rung == "dense_cholesky"
            assert _clean_residual(A, b, x) < HEAL_RES

    def test_dense_direct_routes_as_the_reference(self, system):
        """n ≤ dense_direct_max_n: the dense Cholesky first, no matmul
        through the schedule, one "dense_direct" rung."""
        A, b = system
        settings = dict(num_probes=4, max_cg_iters=4, precond_rank=0, dense_direct_max_n=N)
        (ref_rep, ref_x, ref_s), (rep, x, sched) = _solve_both(A, b, lambda c: c(0), settings)
        assert _trail(rep) == _trail(ref_rep) == [("dense_direct", health.CONVERGED)]
        assert sched.calls == ref_s.calls == 0
        assert rep.num_iters == 0 and rep.residual_norm < HEAL_RES
        np.testing.assert_allclose(x, ref_x, **X_TOL)

    def test_a_device_fault_is_not_a_rung_failure(self, system, monkeypatch):
        """A kernel that cannot be built or launched propagates out of the
        ladder instead of being recorded as an errored rung."""
        from repro_torch.core import inference
        from repro_torch.kernels.build import KernelBuildError, KernelLaunchError

        A, b = system
        _, op = _ops(A, lambda c: c(0, nan_rate=1.0))
        settings = BBMMSettings(num_probes=4, max_cg_iters=4, precond_rank=0,
                                on_failure="degrade")
        real = inference.build_preconditioner
        for exc in (KernelBuildError("nvcc"), KernelLaunchError("cudaError 700"),
                    RuntimeError("CUDA error: an illegal memory access was encountered")):
            def broken(op_, rank, **kw):
                if rank > 0:  # the extend_budget rung's preconditioner
                    raise exc
                return real(op_, rank, **kw)

            monkeypatch.setattr(inference, "build_preconditioner", broken)
            with warnings.catch_warnings(), pytest.raises(type(exc)):
                warnings.simplefilter("ignore")
                solve(op, torch.tensor(b), settings)
        # any other error is the rung's: recorded, and the walk goes on
        def unavailable(op_, rank, **kw):
            if rank > 0:
                raise ValueError("no preconditioner here")
            return real(op_, rank, **kw)

        monkeypatch.setattr(inference, "build_preconditioner", unavailable)
        with collect() as reports, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            solve(op, torch.tensor(b), settings)
        assert [(r.rung, r.status) for r in reports[-1].rungs] == [
            ("initial", health.NON_FINITE), ("extend_budget", None),
            ("dense_cholesky", health.CONVERGED)]

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError, match="on_failure"):
            BBMMSettings(on_failure="panic")


class TestCircuitBreakerParity:
    def _drive(self, cls):
        t = [0.0]
        br = cls(threshold=2, reset_after_s=10.0, clock=lambda: t[0], transition_history=4)
        seen = []
        for step, now in (("allow", 0.0), ("fail", 0.0), ("fail", 0.0), ("allow", 9.9),
                          ("allow", 10.0), ("fail", 10.0), ("allow", 25.0), ("ok", 25.0),
                          ("fail", 26.0), ("fail", 26.0), ("allow", 40.0), ("ok", 41.0)):
            t[0] = now
            got = {"allow": br.allow, "fail": br.record_failure, "ok": br.record_success}[step]()
            seen.append((step, got, br.state, br.failures))
        return seen, list(br.transitions), br.transitions_total

    def test_transitions_match_the_reference_under_a_fake_clock(self):
        assert self._drive(CircuitBreaker) == self._drive(RefCircuitBreaker)
        seen, transitions, total = self._drive(CircuitBreaker)
        assert total == 8 and len(transitions) == 4  # the ring buffer keeps the tail


def _session_data(n=40):
    """tests/test_health.py's session fixture data, as numpy arrays."""
    key = jax.random.PRNGKey(3)
    kx, ky = jax.random.split(key)
    X = jax.random.uniform(kx, (n, 2)) * 2 - 1
    y = jnp.sin(3 * X[:, 0]) + 0.05 * jax.random.normal(ky, (n,))
    return np.asarray(X), np.asarray(y)


def _session(**kw):
    X, y = _session_data()
    gp = ExactGP(mode="cuda", device="cpu", precision="mixed",
                 settings=BBMMSettings(num_probes=4, max_cg_iters=40, on_failure="degrade"))
    sched = FaultSchedule(0, reduced_only=True)
    sess = PosteriorSession(_ChaosModel(gp, sched), gp.init_params(X), X, y, **kw)
    return sess, sched, X, y


def _nudge(params):
    return {k: v + 1e-6 for k, v in params.items()}


class TestServingHardening:
    def test_degraded_query_bitwise_equal_to_last_consistent(self):
        sess, sched, X, y = _session(breaker_threshold=1, breaker_reset_s=1e6, rebuild_retries=0)
        Xq = X[:5] + 0.01
        mean0, var0 = sess.query(Xq)
        sched.total_outage = True
        sess.update_params(_nudge(sess.params))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", SolveHealthWarning)
            mean1, var1 = sess.query(Xq)  # trips the breaker, degrades
            mean2, var2 = sess.query(Xq)  # the breaker already open
        assert sess.breaker.state == CircuitBreaker.OPEN
        assert sess.degraded_queries >= 2 and sess.cache_info.degraded
        for m, v in ((mean1, var1), (mean2, var2)):
            assert torch.equal(m, mean0) and torch.equal(v, var0)

    def test_breaker_recovery_clears_degraded_flag(self):
        sess, sched, X, _ = _session(breaker_threshold=1, breaker_reset_s=0.0, rebuild_retries=0)
        sched.total_outage = True
        sess.update_params(_nudge(sess.params))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", SolveHealthWarning)
            sess.query(X[:5])
        assert sess.breaker.state == CircuitBreaker.OPEN
        sched.total_outage = False
        sess.query(X[:5])  # the half-open trial succeeds at once
        assert sess.breaker.state == CircuitBreaker.CLOSED
        assert not sess.cache_info.degraded and not sess.stale()

    def test_query_deadline_degrades_then_raises_without_cache(self):
        sess, _, X, y = _session(query_deadline_s=0.05)
        mean0, _ = sess.query(X[:3])
        sess.update_params(_nudge(sess.params))
        with sess._rebuild_gate:
            mean1, _ = sess.query(X[:3])  # deadline → degraded fallback
            assert sess.degraded_queries >= 1 and torch.equal(mean1, mean0)
            fresh = PosteriorSession(sess.model, sess.params, X, y, build=False,
                                     query_deadline_s=0.05)
            fresh._rebuild_gate = sess._rebuild_gate  # the held gate, shared
            with pytest.raises(QueryDeadlineExceeded):
                fresh.query(X[:3])

    def test_observe_rejects_non_finite_before_mutation(self):
        sess, _, X, _ = _session()
        n0, v0 = sess.n, sess.cache_info.version
        with pytest.raises(ValueError, match="non-finite"):
            sess.observe(X[:1] + 0.5, np.array([np.nan], np.float32))
        with pytest.raises(ValueError, match="non-finite"):
            sess.observe(np.array([[np.inf, 0.0]], np.float32), np.array([0.1], np.float32))
        assert sess.n == n0 and sess.cache_info.version == v0 and not sess.stale()

    def test_init_rejects_non_finite(self):
        gp = ExactGP(mode="cuda", device="cpu", settings=BBMMSettings(num_probes=4,
                                                                      max_cg_iters=10))
        X = np.ones((4, 2), np.float32)
        X[2, 1] = np.nan
        with pytest.raises(ValueError, match="non-finite"):
            PosteriorSession(gp, gp.init_params(X), X, np.ones(4, np.float32))

    def test_observe_failure_counts_with_breaker(self):
        sess, sched, X, _ = _session(breaker_threshold=1, breaker_reset_s=1e6, rebuild_retries=0,
                                     max_staleness=0)
        sched.total_outage = True
        with pytest.raises(Exception), warnings.catch_warnings():
            warnings.simplefilter("ignore", SolveHealthWarning)
            sess.observe(X[:1] + 0.3, np.array([0.2], np.float32))
        stats = sess.health_stats()
        assert sess.rebuild_failures == stats["rebuild_failures"] == 1
        assert sess.breaker.state == stats["breaker_state"] == CircuitBreaker.OPEN

    def test_session_walks_the_reference_ladder(self):
        """The chaos model's bf16 NaN append heals at precision_f32 in the
        port as in the reference (the same session, the same schedule)."""
        X, y = _session_data()
        ref_gp = RefExactGP(settings=ref_core.BBMMSettings(num_probes=4, max_cg_iters=40,
                                                           on_failure="degrade"),
                            precision="mixed")
        ref_sched = ref_core.FaultSchedule(0, reduced_only=True)
        ref = RefPosteriorSession(RefChaosModel(ref_gp, ref_sched), ref_gp.init_params(X),
                                  jnp.asarray(X), jnp.asarray(y))
        sess, sched, _, _ = _session()
        trails = []
        for s, sc in ((ref, ref_sched), (sess, sched)):
            sc.nan_rate = 1.0
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                assert s.observe(X[:1] * 0.9, y[:1]) == "append"
            trails.append([[(r.rung, r.status) for r in rep.rungs] for rep in s.health_reports])
        assert trails[1] == trails[0]
        assert trails[1][-1][-1] == ("precision_f32", health.CONVERGED)


class TestChaosDrill:
    def test_threaded_chaos_drill_end_to_end(self):
        metrics = run_serve_chaos(n=48, batch=8, requests_per_phase=3, threads=2,
                                  max_cg_iters=25, breaker_reset_s=0.2, device="cpu",
                                  verbose=False, timeout_s=120)
        assert metrics["unhandled_exceptions"] == 0
        assert metrics["precision_escalations"] >= 1
        assert metrics["degraded_queries"] >= 1
        assert metrics["breaker_state"] == CircuitBreaker.CLOSED
        assert metrics["fault_injected"] >= 1
        assert metrics["chaos_ok"]

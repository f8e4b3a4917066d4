"""The port's telemetry against the reference's: the metrics registry, the
Prometheus text and its parser, ``gp_top``, trace spans, the exposition
server, and the null-sink discipline on the solve path (counterpart of
tests/test_obs.py).

The same registry calls must render the reference's Prometheus text byte
for byte, parse to the same families and render the same ``gp_top``
table.  The port's solve path is held to the reference's contract: a
solve is bit-identical with and without sinks, a ladder-healed solve is a
``solve`` span over ``rung:*`` spans over ``mbcg`` spans with the matching
registry series, and a partitioned solve gives one ``panel_launch`` span
per :func:`panel_accounting` record.  Every test starts and ends with no
sink installed.
"""

import json
import threading
import urllib.error
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.launch import gp_top as ref_gp_top
from repro_torch import obs
from repro_torch.core import (
    AddedDiagOperator,
    BBMMSettings,
    DenseOperator,
    FaultInjectingOperator,
    FaultSchedule,
    PartitionedKernelOperator,
    SolveHealthWarning,
    collect,
    panel_accounting,
    solve,
)
from repro_torch.gp import RBFKernel
from repro_torch.launch import gp_top
from repro_torch.launch.gp_serve import _health_payload, run_serve_chaos
from repro_torch.serving import CircuitBreaker

jax.config.update("jax_platform_name", "cpu")

pytestmark = pytest.mark.obs

N = 48


@pytest.fixture(autouse=True)
def _no_leaked_sinks():
    assert obs.active() is None, "a previous test leaked a registry"
    assert obs.active_trace() is None, "a previous test leaked a trace"
    yield
    obs.uninstall()
    obs.enable_annotations(False)


@pytest.fixture(scope="module")
def system():
    """tests/test_obs.py's system, as tensors."""
    key = jax.random.PRNGKey(0)
    Q = jax.random.normal(key, (N, N)) / jnp.sqrt(N)
    A = Q @ Q.T
    b = jax.random.normal(jax.random.fold_in(key, 1), (N,))
    return torch.tensor(np.asarray(A)), torch.tensor(np.asarray(b))


def clean_op(A, sigma2=0.1):
    return AddedDiagOperator(DenseOperator(A), torch.tensor(sigma2))


HEAL = BBMMSettings(num_probes=4, max_cg_iters=60, cg_tol=1e-4, precond_rank=0,
                    precision="mixed", on_failure="degrade")


def healed_solve(A, b):
    """The canonical bf16-NaN heal: (report, x)."""
    op = AddedDiagOperator(
        FaultInjectingOperator(DenseOperator(A),
                               schedule=FaultSchedule(0, nan_rate=1.0, reduced_only=True)),
        torch.tensor(0.1),
    )
    with collect() as reports:
        with pytest.warns(SolveHealthWarning, match="degraded but healed"):
            x = solve(op, b, HEAL)
    return reports[-1], x


def _feed(mod):
    """One fixed sequence of registry calls on a fresh registry of ``mod``."""
    reg = mod.MetricsRegistry()
    reg.inc("solves_total", help="solves", status="CONVERGED", context="solve")
    reg.inc("solves_total", 2, status="MAX_ITERS", context="cache_build")
    reg.inc("q_total", 3.0, result='o"k\n', ctx="a\\b")
    reg.observe("lat_seconds", 0.5, buckets=(1.0, 10.0))
    for v in (1e-7, 0.001, 0.002, 0.004, 0.3, 2e2):
        reg.observe("serving_query_seconds", v, result="ok")
    reg.observe("cg_iterations", 25, mode="plain")
    reg.set_gauge("rows", 2048)
    reg.set_gauge("panel_rows", 177408.0, backend="cuda")
    reg.set_gauge("fit_loss", -1234.56789, model="ExactGP")
    return reg


class TestRegistry:
    def test_prometheus_text_is_the_references_byte_for_byte(self):
        text = _feed(obs).render_prometheus()
        assert text == _feed(ref_obs).render_prometheus()
        assert _feed(obs).snapshot() == _feed(ref_obs).snapshot()

    def test_parse_round_trip_and_gp_top_match_the_reference(self):
        text = _feed(obs).render_prometheus()
        fams = obs.parse_prometheus(text)
        assert fams == ref_obs.parse_prometheus(text)
        assert fams["q_total"]["samples"][0][0]["result"] == 'o"k\n'  # escaping survives
        assert {lab["__part"] for lab, _ in fams["lat_seconds"]["samples"]} == {
            "bucket", "sum", "count"}
        assert gp_top.render(fams) == ref_gp_top.render(fams)
        assert gp_top.render({}) == ref_gp_top.render({})

    def test_gp_top_renders_a_quantile_past_the_last_edge(self):
        """A latency above 1e3 s lands in the +Inf bucket: the port prints
        "+Inf" where the reference's gp_top raises OverflowError
        (ROADMAP Queue C)."""
        reg = obs.MetricsRegistry()
        for v in (0.5, 2e3, 3e3):
            reg.observe("serving_query_seconds", v, result="ok")
        fams = obs.parse_prometheus(reg.render_prometheus())
        row = next(r for r in gp_top.render(fams).splitlines() if "serving_query_seconds" in r)
        assert row.split()[-2:] == ["+Inf", "+Inf"]
        with pytest.raises(OverflowError):
            ref_gp_top.render(fams)

    def test_counter_semantics(self):
        reg = obs.MetricsRegistry()
        reg.inc("q_total", result="ok", ctx="a")
        reg.inc("q_total", 2.0, ctx="a", result="ok")
        assert reg.get("q_total", result="ok", ctx="a") == 3.0 and reg.sum("q_total") == 3.0
        with pytest.raises(ValueError, match="cannot decrease"):
            reg.inc("q_total", -1.0)
        with pytest.raises(ValueError, match="one name, one kind"):
            reg.observe("q_total", 1.0)

    def test_threaded_increments_do_not_race(self):
        reg = obs.MetricsRegistry()
        threads = [threading.Thread(target=lambda: [reg.inc("hits", worker="w")
                                                    for _ in range(500)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert reg.get("hits", worker="w") == 8 * 500

    def test_install_uninstall_and_scoped(self):
        outer = obs.install()
        try:
            obs.inc("seen")
            with obs.installed() as inner:
                obs.inc("seen")
                assert obs.active() is inner
            assert obs.active() is outer
            assert outer.sum("seen") == inner.sum("seen") == 1.0
        finally:
            obs.uninstall()
        obs.inc("seen")
        assert outer.sum("seen") == 1.0


class TestNullSink:
    def test_solve_bitwise_identical_with_and_without_sinks(self, system):
        A, b = system
        s = BBMMSettings(num_probes=4, max_cg_iters=60, cg_tol=1e-4)
        x_bare = solve(clean_op(A), b, s)
        with obs.installed() as reg, obs.trace() as col:
            x_obs = solve(clean_op(A), b, s)
        assert torch.equal(x_bare, x_obs)
        assert reg.sum("cg_solves_total") == 1.0
        assert reg.get("solves_total", status="CONVERGED", context="solve") == 1.0
        assert col.spans("solve") and col.spans("mbcg") and col.spans("rung:initial")

    def test_no_sink_records_nothing(self, system):
        A, b = system
        probe = obs.MetricsRegistry()
        solve(clean_op(A), b, BBMMSettings(num_probes=4, max_cg_iters=40))
        assert probe.snapshot() == {}
        assert obs.active() is None and obs.active_trace() is None

    def test_annotations_are_profiler_ranges_only_when_enabled(self):
        from repro_torch.kernels.kernel_matmul.ops import fused_kernel_matmul_prescaled

        assert obs.annotation("x") is obs.annotation("y")  # the shared null context
        Xs, M = torch.randn(64, 3), torch.randn(64, 2)
        obs.enable_annotations(True)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fused_kernel_matmul_prescaled(Xs, Xs, M, 1.0, 0.1)
        names = {e.key for e in prof.key_averages()}
        assert "cuda:kernel_matmul" in names


class TestLadderHealTelemetry:
    def test_rung_records_are_duration_stamped(self, system):
        A, b = system
        rep, x = healed_solve(A, b)
        assert [r.rung for r in rep.rungs] == ["initial", "precision_f32"]
        assert all(r.duration_s is not None and r.duration_s > 0 for r in rep.rungs)
        assert rep.duration_s == pytest.approx(sum(r.duration_s for r in rep.rungs))
        desc = rep.describe()
        assert "initial:" in desc and "precision_f32:CONVERGED(" in desc and "ms)" in desc
        assert bool(torch.isfinite(x).all())

    def test_trace_json_and_span_nesting(self, system, tmp_path):
        A, b = system
        path = tmp_path / "heal.trace.json"
        with obs.installed() as reg, obs.trace(str(path)) as col:
            rep, _ = healed_solve(A, b)
        doc = json.loads(path.read_text())
        assert set(doc) == {"traceEvents", "displayTimeUnit"}
        assert doc["traceEvents"] == col.to_dict()["traceEvents"]
        for ev in doc["traceEvents"]:
            assert ev["ph"] in ("X", "i") and isinstance(ev["ts"], float)
            assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
        (solve_span,) = col.spans("solve")
        lo, hi = solve_span["ts"], solve_span["ts"] + solve_span["dur"]
        for name in ("rung:initial", "rung:precision_f32"):
            (rung,) = col.spans(name)
            assert rung["tid"] == solve_span["tid"] and lo <= rung["ts"]
            assert rung["ts"] + rung["dur"] <= hi
        assert len(col.spans("mbcg")) >= 2
        assert reg.get("ladder_rungs_total", rung="precision_f32", status="CONVERGED") == 1.0
        assert reg.get("ladder_rungs_total", rung="initial", status=rep.rungs[0].status) == 1.0
        assert reg.sum("solves_degraded_total") >= 1.0
        assert reg.get_histogram("ladder_rung_seconds", rung="precision_f32")[3] == 1
        assert reg.sum("cg_refreshes_total") >= 1.0  # the mixed initial rung refreshed

    def test_trace_saved_even_when_solve_raises(self, system, tmp_path):
        A, b = system
        op = AddedDiagOperator(
            FaultInjectingOperator(DenseOperator(A), schedule=FaultSchedule(0, total_outage=True)),
            torch.tensor(0.1),
        )
        s = BBMMSettings(num_probes=4, max_cg_iters=10, cg_tol=1e-6, precond_rank=0,
                         on_failure="raise")
        path = tmp_path / "failed.trace.json"
        with pytest.raises(Exception), obs.trace(str(path)):
            solve(op, b, s)
        assert any(e["name"] == "solve" for e in json.loads(path.read_text())["traceEvents"])


class TestPartitionedTrace:
    def test_panel_launch_spans_match_accounting(self, tmp_path):
        n, d = 2_000, 4
        gen = torch.Generator().manual_seed(3)
        X = torch.randn(n, d, generator=gen)
        kern = RBFKernel(lengthscale=torch.tensor(0.7), outputscale=torch.tensor(1.3))
        op = AddedDiagOperator(PartitionedKernelOperator(kernel=kern, X=X, panel_rows=512),
                               torch.tensor(1.0))
        b = torch.randn(n, generator=gen)
        s = BBMMSettings(num_probes=2, max_cg_iters=3, cg_tol=0.5, precond_rank=0)
        path = tmp_path / "partitioned.trace.json"
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", SolveHealthWarning)
            with panel_accounting() as launches, obs.installed() as reg, \
                    obs.trace(str(path)) as col:
                x = solve(op, b, s)
        assert bool(torch.isfinite(x).all()) and launches
        spans = col.spans("panel_launch")
        assert len(spans) == len(launches)
        for span, launch in zip(spans, launches):
            assert span["args"]["num_panels"] == launch.num_panels == 4
            assert span["args"]["n"] == n
        assert reg.sum("panel_matmuls_traced_total") == len(launches)
        assert reg.sum("panel_launches_traced_total") == sum(la.num_panels for la in launches)
        json.loads(path.read_text())


class TestBreakerTransitions:
    def test_ring_buffer_caps_history_counter_does_not(self):
        t = [0.0]
        br = CircuitBreaker(threshold=1, reset_after_s=1.0, clock=lambda: t[0],
                            transition_history=4)
        with obs.installed() as reg:
            for _ in range(5):
                br.record_failure()
                t[0] += 1.5
                assert br.allow()
                br.record_success()
        assert br.transitions_total == 15 and len(br.transitions) == 4
        assert [(a, c) for a, c, _ in br.transitions] == [
            ("half_open", "closed"), ("closed", "open"), ("open", "half_open"),
            ("half_open", "closed")]
        assert reg.sum("breaker_transitions_total") == 15.0
        assert reg.get("breaker_transitions_total", **{"from": "closed", "to": "open"}) == 5.0


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, resp.headers.get("Content-Type", ""), resp.read()


class TestMetricsServer:
    def test_routes(self):
        reg = obs.MetricsRegistry()
        reg.inc("pings_total", route="metrics")
        with obs.MetricsServer(port=0, registry=reg,
                               health_fn=lambda: {"status": "ok", "n": 3}) as srv:
            code, ctype, body = _get(srv.url + "/metrics")
            assert code == 200 and "0.0.4" in ctype
            assert 'pings_total{route="metrics"} 1' in body.decode()
            code, _, body = _get(srv.url + "/health")
            assert code == 200 and json.loads(body) == {"status": "ok", "n": 3}
            with pytest.raises(urllib.error.HTTPError) as err:
                _get(srv.url + "/trace")
            assert err.value.code == 404
            with obs.trace() as col:
                col.add_instant("mark")
                assert json.loads(_get(srv.url + "/trace")[2])["traceEvents"][0]["name"] == "mark"

    def test_late_bound_registry(self):
        with obs.MetricsServer(port=0) as srv:
            assert _get(srv.url + "/metrics")[2] == b""
            with obs.installed():
                obs.inc("late_total")
                assert "late_total 1" in _get(srv.url + "/metrics")[2].decode()


class TestChaosMetricsRoundTrip:
    def test_chaos_drill_scrapes_escalations_and_degraded(self):
        holder = {}
        with obs.installed() as reg:
            with obs.MetricsServer(port=0, health_fn=lambda: _health_payload(
                    holder.get("session"))) as srv:
                drill = run_serve_chaos(
                    n=48, batch=8, requests_per_phase=3, threads=2, max_cg_iters=25,
                    breaker_reset_s=0.2, device="cpu", verbose=False, timeout_s=120,
                    session_hook=lambda s: holder.__setitem__("session", s))
                code, _, body = _get(srv.url + "/metrics", timeout=30.0)
                _, _, health_body = _get(srv.url + "/health", timeout=30.0)
        assert drill["chaos_ok"], drill
        fams = obs.parse_prometheus(body.decode())
        esc = [v for lab, v in fams["ladder_rungs_total"]["samples"]
               if lab.get("rung") == "precision_f32"]
        assert esc and sum(esc) >= 1
        assert sum(v for _, v in fams["serving_degraded_total"]["samples"]) >= 1
        assert sum(v for _, v in fams["cg_solves_total"]["samples"]) >= 1
        q = fams["serving_query_seconds"]
        counts = [v for lab, v in q["samples"] if lab["__part"] == "count"]
        assert q["type"] == "histogram" and sum(counts) >= 1
        stats = json.loads(health_body)
        assert stats["status"] == "serving" and stats["breaker_transitions_total"] >= 2
        assert any(k.startswith("serving_") for k in stats["registry"])
        assert reg.sum("serving_degraded_total") >= drill["degraded_queries"] >= 1
        assert "ladder_rungs_total" in gp_top.render(fams)


class TestGpTop:
    def test_main_renders_file(self, tmp_path, capsys):
        reg = obs.MetricsRegistry()
        reg.inc("solves_total", 2, status="CONVERGED", context="solve")
        p = tmp_path / "m.txt"
        p.write_text(reg.render_prometheus())
        assert gp_top.main(["--file", str(p)]) == 0
        out = capsys.readouterr().out
        assert "solves_total" in out and "== counters ==" in out

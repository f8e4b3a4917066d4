"""The port's mixture-of-experts FFN against the reference's
``repro.models.moe``.

* Routing: given the same gates, the port's top-k membership and its
  per-expert top-C selection equal the reference's lines exactly
  (``jax.lax.top_k`` takes the lower index first among ties; the port's
  stable descending sort does too), with exact ties in the gates and with
  the capacity binding.
* ``moe_apply`` and its Switch aux loss against the reference at 1e-4
  (f32), with and without shared experts, in groups and at decode's
  one-group capacity.
* The combine sums each token's hits in a fixed order with gathers only,
  so two runs give the same bits, on 1 thread and on 4.

Parameters are the reference's own init, carried over by
``lm_params_from_jax``; inputs come from a seed with numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro_torch import lm_params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import moe


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-236b")  # without / with shared experts


def _ref_routing(gates, cfg):
    """The reference's routing lines (``repro/models/moe.py:60-77``) on
    the given gates."""
    g, gs, E = gates.shape
    topk_val, topk_idx = jax.lax.top_k(gates, cfg.top_k)
    member = jnp.zeros((g, gs, E), jnp.float32)
    member = jax.vmap(jax.vmap(lambda m, idx, val: m.at[idx].set(val)))(member, topk_idx, topk_val)
    cap = max(int(cfg.capacity_factor * cfg.top_k * gs / E), 1)
    sel_val, sel_idx = jax.lax.top_k(jnp.swapaxes(member, 1, 2), cap)
    return [np.asarray(a) for a in (topk_val, topk_idx, member, sel_val, sel_idx)]


@pytest.mark.parametrize("case", ["softmax", "ties", "capacity binds"])
def test_routing_equals_the_reference_given_the_same_gates(case):
    cfg = get_config("granite-moe-1b-a400m").reduced()  # E = 4, k = 2
    rng = np.random.default_rng(0)
    g, gs = 3, 32
    if case == "ties":  # few distinct values: ties in the top-k and the top-C
        gates = rng.integers(0, 4, (g, gs, cfg.num_experts)).astype(np.float32) / 4
        gates[:, :4] = 0.5  # whole rows tied
    else:
        logits = rng.standard_normal((g, gs, cfg.num_experts)).astype(np.float32)
        logits[..., 0] += 1.5  # a favourite expert, over capacity
        gates = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    if case == "capacity binds":
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    assert moe.capacity(cfg, gs) == max(int(cfg.capacity_factor * cfg.top_k * gs / cfg.num_experts), 1)
    want = _ref_routing(jnp.asarray(gates), cfg)
    got = [t.numpy() for t in moe.route_gates(cfg, torch.from_numpy(np.array(gates)))]
    for name, w, o in zip(("topk_val", "topk_idx", "member", "sel_val", "sel_idx"), want, got):
        np.testing.assert_array_equal(o, w, err_msg=name)
    picks = (want[2] > 0).sum(axis=1)  # tokens that chose each expert, per group
    if case == "capacity binds":
        assert (picks > moe.capacity(cfg, gs)).any()  # some members are dropped
    if case == "ties":
        assert (want[3] == 0).any()  # empty slots, masked in the combine


def _model(arch, seed, **overrides):
    rcfg = ref_get_config(arch).reduced(**overrides)
    cfg = get_config(arch).reduced(**overrides)
    rp = ref_moe.moe_init(jax.random.PRNGKey(seed), rcfg, jnp.float32)
    return rcfg, cfg, rp, lm_params_from_jax(rp, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S,group_size", [(2, 16, 2048), (2, 16, 8), (2, 1, 2048)])
def test_moe_apply_matches_the_reference(arch, B, S, group_size):
    """One group, four groups of 8, and decode's two tokens (one group,
    capacity 1)."""
    rcfg, cfg, rp, p = _model(arch, 1)
    assert ("shared" in p) == (arch == "deepseek-v2-236b")
    x = np.random.default_rng(2).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    rout, raux = ref_moe.moe_apply(rp, rcfg, jnp.asarray(x), group_size=group_size)
    out, aux = moe.moe_apply(p, cfg, torch.from_numpy(x), group_size=group_size)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)
    routing = moe.moe_route(p, cfg, torch.from_numpy(x), group_size=group_size)
    want = _ref_routing(jnp.asarray(routing.gates.numpy()), rcfg)
    np.testing.assert_array_equal(routing.sel_idx.numpy(), want[4])


def test_dispatch_takes_a_given_routing():
    """The f64 witness's device: the routing computed in f32, the dispatch
    and combine run in f64 on it, within f32 rounding of the f32 output."""
    rcfg, cfg, rp, p = _model("deepseek-v2-236b", 3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    routing = moe.moe_route(p, cfg, x)
    out32 = moe.moe_dispatch(p, cfg, x, routing)
    p64 = {k: ({kk: vv.double() for kk, vv in v.items()} if isinstance(v, dict) else v.double())
           for k, v in p.items()}
    out64 = moe.moe_dispatch(p64, cfg, x.double(), routing)
    assert out64.dtype == torch.float64
    np.testing.assert_allclose(out64.numpy(), out32.double().numpy(), **TOL)


@pytest.mark.parametrize("threads", [1, 4])
def test_two_runs_give_the_same_bits(threads):
    rcfg, cfg, rp, p = _model("deepseek-v2-236b", 5, num_experts=8, top_k=4)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 32, cfg.d_model)).astype(np.float32))
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        first, aux1 = moe.moe_apply(p, cfg, x, group_size=64)
        second, aux2 = moe.moe_apply(p, cfg, x, group_size=64)
    finally:
        torch.set_num_threads(before)
    assert torch.equal(first, second) and torch.equal(aux1, aux2)

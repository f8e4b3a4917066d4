"""The LM on a mesh: one gloo world of 4 CPU ranks, (data, model) = (2, 2).

Parameters are the reference's init carried over by ``lm_params_from_jax``
and laid out on the mesh by ``params_shardings``; batches are numpy tokens
from a seed.  The world runs every case once and returns its results; the
tests hold them against the port's single-process run and the
reference's single-device run on the same inputs:

  * the reduced llama of the reference's mesh test (4 heads, 2 KV heads,
    vocab 512, batch (8, 17)): loss and every gradient at
    ``test_torch_lm_train``'s GRAD_TOL, one ``make_train_step`` step at its
    STEP_TOL with its Adam rule — and the same with ``use_sp``, with
    ``grad_reduce_dtype="bfloat16"``, and with one KV head, which the model
    axis does not divide (each rank's q heads over a copy of it);
  * the reduced granite-moe (4 experts, top 2): every routing call equal to
    the single-process run's, the loss and gradients within tolerance; the
    expert-parallel block alone with groups that lie within data shards;
  * prefill and 4 decode steps on the cache laid out by ``cache_shardings``;
  * ``pipeline_forward`` (S = 4, M = 8, mb = 4, d = 16) on a (stage,) mesh of
    the same world: bit for bit against the port's sequential loop, and
    within the reference test's rtol 2e-3 of the reference's formula;
  * elastic restore: a checkpoint saved from a 4-way ("data",) layout,
    restored onto (2, 2) with ("model", "data") placements;
  * B4 and B5 on DTensor operands: batch- and head-sharded ones launch on
    each rank's shard (here their plain versions) and give the whole
    result; a head_dim or sequence shard, a pending sum or a plain operand
    among DTensors raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import make_train_step as ref_make_train_step
from repro_torch import lm_params_from_jax
from repro_torch.models import build_model, loss_and_grads, make_train_step, moe
from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_unflatten
from torch_lm_mesh_world import (
    D_PIPE,
    LR,
    M_PIPE,
    MB_PIPE,
    S_PIPE,
    TRAIN_CASES,
    port_cfg,
    run_world,
    to_torch,
)

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)  # tests/test_torch_lm_train.py's
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(case):
    (arch, red), opts = TRAIN_CASES[case]
    return dataclasses.replace(ref_get_config(arch).reduced(**red), **opts), port_cfg(case)


def _numpy(tree):
    return tree_unflatten(tree, [x.detach().numpy() for x in tree_leaves(tree)])


# --- the parent's side ----------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, the reference's and the port's single-process results,
    and the world's."""
    from repro_torch.distributed import spawn_world

    rng = np.random.default_rng(0)
    inputs = {"train": {}, "ckpt_dir": str(tmp_path_factory.mktemp("ckpt"))}
    single, ref = {}, {}
    for case in TRAIN_CASES:
        rcfg, cfg = _cfgs(case)
        rbundle, bundle = ref_build_model(rcfg), build_model(cfg)
        rparams = rbundle.init(jax.random.PRNGKey(0))
        tokens = rng.integers(0, 512, (8, 17)).astype(np.int64)
        params = lm_params_from_jax(rparams, device="cpu")
        inputs["train"][case] = (_numpy(params), tokens)
        routings = []
        real = moe.route_gates
        moe.route_gates = lambda *a: routings.append(real(*a)) or routings[-1]
        try:
            loss, grads = loss_and_grads(bundle, params, {"tokens": torch.from_numpy(tokens)})
        finally:
            moe.route_gates = real
        single[case] = {"loss": float(loss), "grads": [g.numpy() for g in tree_leaves(grads)],
                        "routing": [(r[1].numpy(), r[3].detach().numpy() > 0, r[4].numpy())
                                    for r in routings],
                        "paths": tree_flatten_with_paths(params)[0]}
        if case != "granite":
            step, init_opt = make_train_step(bundle, lr=LR)
            p = to_torch(_numpy(params))
            p2, o2, m = step(p, init_opt(p), {"tokens": torch.from_numpy(tokens)})
            single[case].update(step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                params=[x.numpy() for x in tree_leaves(p2)],
                                mu=[x.numpy() for x in tree_leaves(o2.mu)],
                                nu=[x.numpy() for x in tree_leaves(o2.nu)])
            rstep, rinit = ref_make_train_step(rbundle, lr=LR)
            jb = {"tokens": jnp.asarray(tokens.astype(np.int32))}
            (rloss, rgrads), (rp2, ro2, rm) = jax.jit(lambda p, o, b: (
                jax.value_and_grad(lambda q: rbundle.loss(q, b, True))(p), rstep(p, o, b)))(
                    rparams, rinit(rparams), jb)
            ref[case] = {"loss": float(rloss),
                         "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(rgrads)],
                         "step_loss": float(rm["loss"]), "grad_norm": float(rm["grad_norm"]),
                         "params": [np.asarray(x) for x in jax.tree_util.tree_leaves(rp2)],
                         "mu": [np.asarray(x) for x in jax.tree_util.tree_leaves(ro2.mu)]}

    _, gcfg = _cfgs("granite")
    p = {k: v for k, v in inputs["train"]["granite"][0]["layers"]["moe"].items()}
    p = tree_unflatten(p, [x[0] for x in tree_leaves(p)])  # layer 0's block
    x = rng.standard_normal((4, 16, gcfg.d_model)).astype(np.float32)
    inputs["moe_block"] = {"params": p, "x": x}
    with torch.no_grad():
        y, aux = moe.moe_apply(to_torch(p), gcfg, torch.from_numpy(x), group_size=16)
    single["moe_block"] = (y.numpy(), float(aux))

    _, cfg = _cfgs("llama")
    bundle = build_model(cfg)
    inputs["serve"] = rng.integers(0, 512, (4, 16)).astype(np.int64)
    inputs["serve_next"] = rng.integers(0, 512, (4, 4)).astype(np.int64)
    params = to_torch(inputs["train"]["llama"][0])
    with torch.no_grad():
        logits, cache = bundle.prefill(params, {"tokens": torch.from_numpy(inputs["serve"])}, 24,
                                       True)
        served = [logits.numpy()]
        pos = torch.full((4,), 16)
        for i in range(4):
            logits, cache = bundle.decode(params, torch.from_numpy(inputs["serve_next"][:, i]),
                                          cache, pos + i)
            served.append(logits.numpy())
    single["serve"] = served

    inputs["pipe_w"] = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                                    (S_PIPE, D_PIPE, D_PIPE)) * 0.3)
    inputs["pipe_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                    (M_PIPE, MB_PIPE, D_PIPE)))
    ref_pipe = jnp.asarray(inputs["pipe_x"])
    for i in range(S_PIPE):
        ref_pipe = jnp.tanh(ref_pipe @ jnp.asarray(inputs["pipe_w"])[i])
    ref["pipe"] = np.asarray(ref_pipe)

    kr = np.random.default_rng(3)
    inputs["kernels"] = {
        "q": kr.standard_normal((4, 4, 16, 8)).astype(np.float32),
        "k": kr.standard_normal((4, 2, 16, 8)).astype(np.float32),
        "v": kr.standard_normal((4, 2, 16, 8)).astype(np.float32),
        "x": kr.standard_normal((4, 4, 16, 8)).astype(np.float32),
        "dt": kr.uniform(0.01, 0.1, (4, 4, 16)).astype(np.float32),
        "A": -kr.uniform(0.5, 2.0, (4,)).astype(np.float32),
        "B": kr.standard_normal((4, 16, 8)).astype(np.float32),
        "C": kr.standard_normal((4, 16, 8)).astype(np.float32),
    }
    world = spawn_world(run_world, 4, "gloo", args=(inputs,), timeout=300, threads=1)
    return {"world": world, "single": single, "ref": ref}


def _close_grads(ours, theirs, tol=GRAD_TOL):
    for path, g, r in zip(ours["paths"], ours["grads"], theirs["grads"]):
        np.testing.assert_allclose(g, r, **tol, err_msg=path)


def _step_matches(mesh, other, paths, bf16=False):
    """test_torch_lm_train's rule: loss, gradient norm, moments, and the
    parameters at STEP_TOL where the first moment is firm (else Adam's bound
    |Δp| ≤ 2·lr).  With bf16 gradients a moment may differ by one bf16
    rounding of its gradient (one ulp, ≤ 2⁻⁷ relative), the cast's own
    quantum: the two f32 gradients differ in their last bits."""
    np.testing.assert_allclose(mesh["step_loss"], other["step_loss"], rtol=1e-5)
    np.testing.assert_allclose(mesh["grad_norm"], other["grad_norm"], rtol=1e-4)
    floor = 1e-6 * max(np.abs(m).max() for m in other["mu"])
    for path, x, r in zip(paths, mesh["mu"], other["mu"]):
        if bf16:
            assert np.all(np.abs(x - r) <= 2**-7 * np.abs(r) + floor), path
        else:
            assert np.abs(x - r).max() <= 1e-4 * np.abs(r).max() + floor, path
    for path, x, r, mu in zip(paths, mesh["params"], other["params"], other["mu"]):
        firm = np.abs(mu) >= max(1e-3 * np.abs(mu).max(), floor)
        assert np.abs(x - r).max() <= 2 * LR + 1e-5, path
        np.testing.assert_allclose(x[firm], r[firm], **STEP_TOL, err_msg=path)


@pytest.mark.parametrize("case", ["llama", "llama_sp", "llama_bf16grad", "llama_kv1"])
def test_mesh_train_step_matches_one_process_and_the_reference(run, case):
    world, single, ref = run["world"], run["single"][case], run["ref"][case]
    mesh = world[0][case]
    if case == "llama_kv1":  # each rank attends its 2 q heads over one KV head's copy
        assert mesh["attended"] and all(a == ("(Shard(dim=0), Shard(dim=2))", (4, 16, 2, 32),
                                              (4, 16, 1, 32)) for a in mesh["attended"])
    assert len({w[case]["loss"] for w in world}) == 1  # every rank the same bits
    paths = single["paths"]
    np.testing.assert_allclose(mesh["loss"], single["loss"], rtol=1e-5)
    np.testing.assert_allclose(mesh["loss"], ref["loss"], rtol=1e-5)
    _close_grads(dict(mesh, paths=paths), single)
    _close_grads(dict(mesh, paths=paths), ref)
    bf16 = case == "llama_bf16grad"
    _step_matches(mesh, single, paths, bf16)
    _step_matches(mesh, ref, paths, bf16)


def test_moe_on_the_mesh_routes_as_one_process(run):
    mesh, single = run["world"][0]["granite"], run["single"]["granite"]
    assert mesh["routing"] and len(mesh["routing"]) == len(single["routing"])
    for (idx, live, sel), (ridx, rlive, rsel) in zip(mesh["routing"], single["routing"]):
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_array_equal(live, rlive)
        np.testing.assert_array_equal(sel[live], rsel[rlive])
    np.testing.assert_allclose(mesh["loss"], single["loss"], rtol=1e-5)
    _close_grads(dict(mesh, paths=single["paths"]), single)


def test_expert_parallel_block_with_groups_inside_data_shards(run):
    (y, aux), (ry, raux) = run["world"][0]["moe_block"], run["single"]["moe_block"]
    np.testing.assert_allclose(y, ry, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux, raux, rtol=1e-6)


def test_sharded_prefill_and_decode_match_one_process(run):
    mesh, single = run["world"][0]["serve"], run["single"]["serve"]
    assert mesh["placements"] == mesh["want"]  # the cache where cache_shardings puts it
    tol = 1e-4
    for got, want in zip(mesh["logits"], single):
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        top2 = np.sort(want, axis=-1)[:, -2:]
        firm = top2[:, 1] - top2[:, 0] > 2 * tol
        np.testing.assert_array_equal(got.argmax(-1)[firm], want.argmax(-1)[firm])


def test_decode_over_a_sequence_sharded_cache_combines_the_slices(run):
    """The long-context decode's attention on a cache sharded over "data"
    along its sequence: each rank's slice attended locally and the slices'
    softmax statistics combined (log-sum-exp) equal the plain attention
    over the whole cache, whichever slices the active length reaches."""
    for got, want in run["world"][0]["sequence_decode"]:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_pipeline_matches_the_sequential_loop(run):
    for rank_out in run["world"]:
        piped, seq = rank_out["pipe"]
        np.testing.assert_array_equal(piped, seq)  # bit for bit, on every rank
    np.testing.assert_allclose(run["world"][0]["pipe"][0], run["ref"]["pipe"], rtol=2e-3,
                               atol=2e-3)


def test_elastic_restore_reshards_onto_another_mesh(run):
    from torch.distributed.tensor import Shard

    want = np.arange(64.0).reshape(8, 8)
    for full, placements, local, (d, m) in (w["restore"] for w in run["world"]):
        np.testing.assert_array_equal(full, want)
        assert placements == (Shard(1), Shard(0))  # ("model", "data") on (data, model)
        np.testing.assert_array_equal(local, want[4 * m:4 * m + 4, 4 * d:4 * d + 4])


def test_b4_and_b5_launch_on_batch_and_head_shards_and_refuse_other_layouts(run):
    from torch.distributed.tensor import Shard

    res = run["world"][0]["kernel_layouts"]
    assert res["b4_heads"] == ((Shard(0), Shard(1)), True)  # the whole, bit for bit
    assert res["b5_heads"] == ((Shard(0), Shard(1)), True)
    for name, err in res["refused"].items():
        assert err is not None, f"{name} launched"
        if name == "b4_plain_operand":
            assert err.startswith("TypeError")
        else:
            assert err.startswith("ValueError") and "redistribute first" in err, err


def test_sync_collectives_give_dtensors_bits(run):
    """The synchronous c10d path that DTensors on CUDA over gloo take
    (ROADMAP Queue C item 33), held here on CPU tensors against DTensor's
    own functional collectives."""
    assert run["world"][0]["sync_collectives"] == {k: True for k in (
        "all-gather", "all-reduce", "average", "reduce-scatter", "all-to-all",
        "uneven all-to-all")}

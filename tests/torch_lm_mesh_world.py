"""The body of ``tests/test_torch_lm_mesh.py``'s world: every case on a
(data, model) = (2, 2) mesh of 4 gloo ranks, results as numpy.  A module of
its own so that the spawned ranks import ``repro_torch`` and no JAX."""

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, loss_and_grads, make_train_step, moe
from repro_torch.tree import tree_leaves, tree_unflatten

LR = 1e-3  # the reference's mesh test
SHAPE = (2, 2)
LLAMA = ("llama3.2-1b", dict(num_heads=4, num_kv_heads=2, vocab_size=512))
# one KV head, which "model" = 2 does not divide: each rank's 2 q heads read it
LLAMA_KV1 = ("llama3.2-1b", dict(num_heads=4, num_kv_heads=1, vocab_size=512))
GRANITE = ("granite-moe-1b-a400m", dict(num_experts=4, top_k=2, vocab_size=512))
TRAIN_CASES = {"llama": (LLAMA, {}), "llama_sp": (LLAMA, {"use_sp": True}),
               "llama_bf16grad": (LLAMA, {"grad_reduce_dtype": "bfloat16"}),
               "llama_kv1": (LLAMA_KV1, {}), "granite": (GRANITE, {})}
S_PIPE, M_PIPE, MB_PIPE, D_PIPE = 4, 8, 4, 16


def port_cfg(case):
    (arch, red), opts = TRAIN_CASES[case]
    return dataclasses.replace(get_config(arch).reduced(**red), **opts)


def to_torch(tree):
    return tree_unflatten(tree, [torch.from_numpy(np.array(x)) for x in tree_leaves(tree)])


def pipe_stage(w, x):
    return torch.tanh(x @ w)


def sequential(ws, x):
    for i in range(ws.shape[0]):
        x = pipe_stage(ws[i], x)
    return x


def run_world(rank, world, inputs):
    """Every case on the (2, 2) mesh; results as numpy (rank 0's are read,
    every rank's loss bits are checked equal)."""
    warnings.filterwarnings("ignore")
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.models import attention
    from repro_torch.models.model import mesh_context

    mesh = sh.make_mesh(SHAPE, ("data", "model"))
    out = {}
    with sh.use_mesh(mesh):
        for case, (params_np, tokens) in inputs["train"].items():
            cfg = port_cfg(case)
            bundle = build_model(cfg)
            params = to_torch(params_np)
            specs = sh.params_shardings(params, bundle.stacked_paths)
            batch = {"tokens": sh.distribute(torch.from_numpy(tokens),
                                             sh.NamedSharding(mesh, sh.p_batch(None)))}
            routings, attended = [], []
            real, real_attend = moe.route_gates, attention._attend_on_shards
            moe.route_gates = lambda *a: routings.append(real(*a)) or routings[-1]
            attention._attend_on_shards = lambda q, k, *a: attended.append(
                (str(tuple(q.placements)), tuple(q.to_local().shape), tuple(k.to_local().shape))) \
                or real_attend(q, k, *a)
            try:
                dp = sh.distribute_tree(params, sh.named_shardings(mesh, specs))
                with mesh_context(dp):
                    loss, grads = loss_and_grads(bundle, dp, batch)
            finally:
                moe.route_gates, attention._attend_on_shards = real, real_attend
            res = {"loss": float(loss.full_tensor()),
                   "grads": [g.full_tensor().numpy() for g in tree_leaves(grads)],
                   "routing": [(r[1].numpy(), r[3].detach().numpy() > 0, r[4].numpy())
                               for r in routings],
                   "attended": attended}
            if case != "granite":
                step, init_opt = make_train_step(bundle, lr=LR)
                p2, o2, m = step(dp, init_opt(dp), batch)
                res.update(step_loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                           params=[x.full_tensor().numpy() for x in tree_leaves(p2)],
                           mu=[x.full_tensor().numpy() for x in tree_leaves(o2.mu)],
                           nu=[x.full_tensor().numpy() for x in tree_leaves(o2.nu)])
            out[case] = res

        # the expert-parallel block alone, its groups within the data shards
        cfg = port_cfg("granite")
        p = to_torch(inputs["moe_block"]["params"])
        dp = sh.distribute_tree(p, sh.named_shardings(mesh, sh.params_shardings(p)))
        x = sh.distribute(torch.from_numpy(inputs["moe_block"]["x"]),
                          sh.NamedSharding(mesh, sh.p_batch(None, None)))
        with torch.no_grad(), mesh_context(dp):
            y, aux = moe.moe_apply(dp, cfg, x, group_size=16)
        out["moe_block"] = (y.full_tensor().numpy(), float(aux.full_tensor()))

        # prefill and 4 decode steps on the cache laid out by cache_shardings
        cfg = port_cfg("llama")
        bundle = build_model(cfg)
        params = to_torch(inputs["train"]["llama"][0])
        dp = sh.distribute_tree(params, sh.named_shardings(
            mesh, sh.params_shardings(params, bundle.stacked_paths)))
        tok = sh.distribute(torch.from_numpy(inputs["serve"]),
                            sh.NamedSharding(mesh, sh.p_batch(None)))
        with torch.no_grad(), mesh_context(dp):
            logits, cache = bundle.prefill(dp, {"tokens": tok}, 24, True)
            cache = sh.constrain_tree(cache, sh.cache_shardings(cache))
            placements = [tuple(c.placements) for c in tree_leaves(cache)]
            served = [logits.full_tensor().numpy()]
            pos = torch.full((tok.shape[0],), tok.shape[1])
            nxt = torch.from_numpy(inputs["serve_next"])
            for i in range(4):
                logits, cache = bundle.decode(dp, nxt[:, i], cache, pos + i)
                served.append(logits.full_tensor().numpy())
        out["serve"] = {"logits": served, "placements": placements,
                        "want": [tuple(sh.placements(s, mesh.axis_names))
                                 for s in tree_leaves(sh.cache_shardings(cache))]}

    out["sequence_decode"] = _sequence_sharded_decode(mesh)
    out["kernel_layouts"] = _kernel_layouts(mesh, inputs["kernels"])
    out["sync_collectives"] = _sync_collectives_agree(mesh)

    # the pipeline, on a (stage,) mesh of the same world
    stages = sh.make_mesh((S_PIPE,), ("stage",))
    ws, xs = torch.from_numpy(inputs["pipe_w"]), torch.from_numpy(inputs["pipe_x"])
    piped = pipeline_forward(pipe_stage, ws, xs, mesh=stages)
    seq = torch.stack([sequential(ws, xs[m]) for m in range(M_PIPE)])
    out["pipe"] = (piped.numpy(), seq.numpy())

    # elastic restore: save from 4-way ("data",), restore onto (2, 2)
    w = torch.arange(64.0).reshape(8, 8)
    mesh4 = sh.make_mesh((4,), ("data",))
    ck = Checkpointer(inputs["ckpt_dir"])
    ck.save(0, {"w": sh.distribute(w, sh.NamedSharding(mesh4, sh.P("data", None)))})
    torch.distributed.barrier()
    target = {"w": sh.NamedSharding(mesh, sh.P("model", "data"))}
    back = ck.restore(0, {"w": w}, shardings=target)["w"]
    out["restore"] = (back.full_tensor().numpy(), tuple(back.placements),
                      back.to_local().numpy(), mesh.coords(rank))
    return out


def _sequence_sharded_decode(mesh):
    """Decode attention at batch 1 over a cache whose sequence lies over
    "data" (KV heads over "model"), as ``cache_shardings`` lays out a
    long-context cache: the log-sum-exp combine of the ranks' slices
    against the plain attention over the whole cache, for active lengths
    that end in the second slice, at its start (that slice all masked
    but its first position) and in the first (the second slice empty)."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.attention import _sdpa, _sdpa_plain

    g = torch.Generator().manual_seed(3)
    q = torch.randn((1, 1, 4, 8), generator=g)
    k, v = (torch.randn((1, 16, 2, 8), generator=g) for _ in range(2))
    dk, dv = (sh.distribute(t, sh.NamedSharding(mesh, sh.P(None, "data", "model", None)))
              for t in (k, v))
    dq = sh.distribute(q, sh.NamedSharding(mesh, sh.P(None, None, "model", None)))
    res = []
    with torch.no_grad():
        for n in (11, 9, 5):
            kv_len = torch.tensor([n])
            got = _sdpa(dq, dk, dv, causal=False, kv_len=kv_len).full_tensor()
            res.append((got.numpy(), _sdpa_plain(q, k, v, False, kv_len).numpy()))
    return res


def _kernel_layouts(mesh, arrays):
    """B4 and B5 on DTensor operands: batch over "data" and heads over
    "model" launch on each rank's shard (the plain version on these CPU
    shards) and equal the whole computation; a head_dim or sequence shard,
    a pending sum or a plain operand among DTensors raises."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_cuda

    dm = mesh.device_mesh()
    q, k, v = (torch.from_numpy(arrays[n]) for n in ("q", "k", "v"))
    x, dt, A, B, C = (torch.from_numpy(arrays[n]) for n in ("x", "dt", "A", "B", "C"))

    def place(t, *pl):
        return sh.distribute(t, sh.NamedSharding(mesh, sh.P(*pl)))

    res = {}
    got = flash_attention_cuda(place(q, "data", "model"), place(k, "data", "model"),
                               place(v, "data", "model"), causal=True)
    res["b4_heads"] = (tuple(got.placements), torch.equal(
        got.full_tensor(), gqa_attention_plain(q, k, v, causal=True)))
    got = ssd_scan_cuda(place(x, "data", "model"), place(dt, "data", "model"), place(A, "model"),
                        place(B, "data"), place(C, "data"), chunk=8)
    res["b5_heads"] = (tuple(got.placements), bool(torch.allclose(
        got.full_tensor(), ssd_scan_chunked_ref(x, dt, A, B, C, chunk=8), rtol=1e-6, atol=1e-6)))
    refused = {}
    cases = {
        "b4_head_dim": lambda: flash_attention_cuda(
            place(q, "data", None, None, "model"), place(k, "data", None, None, "model"),
            place(v, "data", None, None, "model")),
        "b4_sequence": lambda: flash_attention_cuda(
            place(q, None, None, "model"), place(k, None, None, "model"),
            place(v, None, None, "model")),
        "b4_pending_sum": lambda: flash_attention_cuda(*(DTensor.from_local(
            t, dm, [Replicate(), Partial()]) for t in (q, k, v))),
        "b4_plain_operand": lambda: flash_attention_cuda(place(q, "data"), k, v),
        "b5_sequence": lambda: ssd_scan_cuda(
            place(x, None, None, "model"), place(dt, None, None, "model"), place(A),
            place(B, None, "model"), place(C, None, "model"), chunk=8),
    }
    for name, fn in cases.items():
        try:
            fn()
            refused[name] = None
        except (ValueError, TypeError) as e:
            refused[name] = type(e).__name__ + ": " + str(e)
    res["refused"] = refused
    res["shard"] = str(Shard(1))
    return res


def _sync_collectives_agree(mesh):
    """Each redistribution DTensor makes (all-gather, all-reduce, average,
    reduce-scatter, all-to-all), by DTensor's functional collectives and
    under ``sync_collectives``: the same bits."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed import sharding as sh

    dm = mesh.device_mesh()
    x = torch.arange(64.0).reshape(8, 8) + torch.distributed.get_rank()
    out = {}
    for name, src, dst in (("all-gather", [Shard(0), Shard(1)], [Replicate(), Replicate()]),
                           ("all-reduce", [Partial(), Partial()], [Replicate(), Replicate()]),
                           ("average", [Partial("avg"), Replicate()], [Replicate(), Replicate()]),
                           ("reduce-scatter", [Partial(), Replicate()], [Shard(0), Replicate()]),
                           ("all-to-all", [Shard(0), Shard(1)], [Shard(1), Shard(0)])):
        t = DTensor.from_local(x[:4, :4].clone() if src[0] == Shard(0) else x.clone(), dm, src)
        a = t.redistribute(dm, dst).to_local()
        with sh.sync_collectives():
            b = t.redistribute(dm, dst).to_local()
        out[name] = bool(torch.equal(a, b))
    # splits that differ between ranks: rank r sends (r + j) % 3 + 1 rows to rank j
    n, me = torch.distributed.get_world_size(), torch.distributed.get_rank()
    ins = [(me + j) % 3 + 1 for j in range(n)]
    outs = [(j + me) % 3 + 1 for j in range(n)]
    y = torch.arange(sum(ins) * 3.0).reshape(-1, 3) + 100 * me
    a = y.new_empty((sum(outs), 3))
    torch.distributed.all_to_all_single(a, y, outs, ins)
    c10d = torch.ops._c10d_functional
    with sh.sync_collectives():
        b = c10d.wait_tensor(c10d.all_to_all_single(
            y, outs, ins, torch.distributed.group.WORLD.group_name))
    out["uneven all-to-all"] = bool(torch.equal(a, b))
    return out

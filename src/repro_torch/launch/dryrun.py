"""Multi-pod dry-run: every (arch × shape × mesh) cell's step, run on fake
tensors as rank 0 of a fake process group — the counterpart of
``repro.launch.dryrun``.

For each cell the step is built as the reference's ``_eval_shapes`` builds
it (parameters, optimizer state or cache, and the batch, each laid out by
the sharding rules) and run once under ``FakeTensorMode`` on a fake world
of 256 (16 × 16) or 512 (2 × 16 × 16) ranks, so no value is computed and no
device is touched.  That the step runs is the pass/fail gate (the
reference's compile); a counting dispatch mode records, for rank 0:

  * per-device memory: the peak of the live local storages, the step's
    inputs included (the reference's ``memory_analysis()``);
  * per-device FLOPs, from ``torch.utils.flop_counter``'s formulas on the
    LOCAL shards (DTensor ops are left to DTensor, whose local ops the
    mode then sees; its global shape inference is not counted);
  * bytes accessed: the inputs and outputs of every local op that is not a
    view (no fusion: an upper bound of what a fused program moves);
  * collective bytes by kind: the output operands of every collective as
    it is issued (the reference parses them from the HLO).

The port's layers are a Python loop, so the whole depth is counted as it
runs: the reference's L = 1 / L = 2 extrapolation is not needed.  A train
cell's backward re-runs each rematerialised block's forward inside the
counting mode (``models.layers.remat``), so the recompute's FLOPs and its
parameter regathers are counted, and the peak holds only the blocks'
inputs.  A cell that raises keeps the port's innermost frames in its
artifact (``port_frames``).  The GP
cells are analytic, as the reference's are (``gp_cell``).

Usage (host only, no GPU):
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --gp
  python -m repro_torch.launch.report
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist

from ..configs import ALL_ARCHS, SHAPES, get_config, runnable_shapes
from ..distributed.sharding import (
    Mesh,
    NamedSharding,
    cache_shardings,
    distribute,
    distribute_tree,
    is_dtensor,
    named_shardings,
    params_shardings,
    use_mesh,
)
from ..models import (
    batch_shardings,
    build_model,
    input_specs,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
from ..tree import tree_leaves
from .roofline import PEAK_FLOPS, PEAK_FLOPS_F32, CellAnalysis, model_flops_estimate

#: the default artifact directory (listed in .gitignore)
ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "../../../dryrun_out")

GP_ARCHS = ["gp-exact-2m", "gp-exact-8m"]

MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def mesh_name(shape) -> str:
    return "x".join(str(s) for s in shape)


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0: every
    collective returns at once and moves nothing.  Process-global: it is
    destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the counting mode
# --------------------------------------------------------------------------

_COLLECTIVES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
                ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"),
                ("alltoall", "all-to-all"), ("broadcast", "broadcast"),
                ("send", "collective-permute"), ("recv", "collective-permute"))


def _collective_kind(func) -> str | None:
    ns, name = func.namespace, func.name()
    if ns not in ("_c10d_functional", "_c10d_functional_autograd", "c10d"):
        return None
    for key, kind in _COLLECTIVES:
        if key in name:
            return kind
    return None


def _tensors(tree):
    from torch.utils._pytree import tree_leaves as leaves

    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


class StepCounter:
    """FLOPs, bytes, collective bytes and the peak of live storage of the
    local ops run under it (see the module docstring)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        self.flops = 0
        self.bytes = 0
        self.collectives: dict = {}
        self.live = 0
        self.peak = 0
        self._refs: dict = {}
        self._paused = 0
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(is_dtensor(x) for x in _tensors((args, kwargs))):
                    return NotImplemented  # DTensor runs it; its local ops come back here
                out = func(*args, **kwargs)
                if not counter._paused:
                    counter._count(func, args, kwargs, out, flop_registry)
                return out

        self.mode = _Mode()

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        n = st.nbytes()

        def gone(_, key=key, n=n):
            self._refs.pop(key, None)
            self.live -= n

        self._refs[key] = weakref.ref(st, gone)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _count(self, func, args, kwargs, out, flop_registry):
        outs = _tensors(out)
        kind = _collective_kind(func)
        if kind is not None:
            nbytes = sum(t.numel() * t.element_size() for t in outs)
            self.collectives[kind] = self.collectives.get(kind, 0) + nbytes
        else:
            packet = func.overloadpacket
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            returns = func._schema.returns
            is_view = bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                            for r in returns)
            if not is_view:
                ins = _tensors((args, kwargs))
                self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self.track(t)

    @contextlib.contextmanager
    def counting(self):
        """The mode, with DTensor's shape inference (which runs each new op
        once on global shapes) left uncounted."""
        try:
            from torch.distributed.tensor._sharding_prop import ShardingPropagator
        except ImportError:  # a torch without it: nothing to leave out
            ShardingPropagator = None
        name = "_propagate_tensor_meta_non_cached"
        real = getattr(ShardingPropagator, name, None)
        if real is not None:
            def paused(*a, **kw):
                self._paused += 1
                try:
                    return real(*a, **kw)
                finally:
                    self._paused -= 1

            setattr(ShardingPropagator, name, paused)
        try:
            with self.mode:
                yield self
        finally:
            if real is not None:
                setattr(ShardingPropagator, name, real)


# --------------------------------------------------------------------------
# one cell
# --------------------------------------------------------------------------


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def build_cell(cfg, shape, mesh):
    """(run, inputs) of a cell's step under the ambient mesh and an active
    ``FakeTensorMode``: ``run()`` runs it once; ``inputs`` are its
    arguments, laid out by the rules (the reference's ``_eval_shapes``)."""
    bundle = build_model(cfg)
    max_seq = max(shape.seq_len + 1, 8)
    params = bundle.init(torch.Generator(), max_seq=max_seq)
    params = distribute_tree(params, named_shardings(
        mesh, params_shardings(params, bundle.stacked_paths)))
    b_specs = batch_shardings(cfg, shape)
    batch = {k: distribute(torch.zeros(v.shape, dtype=v.dtype), NamedSharding(mesh, b_specs[k]))
             for k, v in input_specs(cfg, shape).items()}

    if shape.kind == "train":
        step, init_opt = make_train_step(bundle)
        opt = init_opt(params)
        return (lambda: step(params, opt, batch)), (params, opt, batch)
    if shape.kind == "prefill":
        step = make_prefill_step(bundle, cache_len=shape.seq_len)
        return (lambda: step(params, batch)), (params, batch)
    step = make_serve_step(bundle)
    cache = bundle.init_cache(params, shape.global_batch, shape.seq_len)
    cache = distribute_tree(cache, named_shardings(mesh, cache_shardings(cache)))
    return (lambda: step(params, batch["token"], cache, batch["pos"])), (params, cache, batch)


def measure_cell(cfg, shape, mesh) -> dict:
    """Run one cell's step on fake tensors under ``mesh`` and return rank
    0's counts (needs the fake world the mesh lives on)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh.device_mesh("cpu")  # built outside the fake mode: its rank map is real
    counter = StepCounter()
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), use_mesh(mesh):
        run, inputs = build_cell(cfg, shape, mesh)
        for x in tree_leaves(inputs):
            if isinstance(x, torch.Tensor):
                counter.track(_local(x))
        args_bytes = counter.live
        with counter.counting():
            out = run()
        del out
    return {"seconds": time.time() - t0, "flops": float(counter.flops),
            "bytes": float(counter.bytes), "collectives": dict(counter.collectives),
            "per_device_bytes": int(counter.peak), "argument_bytes": int(args_bytes)}


OPT_FIELDS = {
    "chunked": {"chunked_attention": True},
    "sp": {"use_sp": True},
    "bf16grad": {"grad_reduce_dtype": "bfloat16"},
}


def apply_opts(cfg, opts: str):
    for o in filter(None, (opts or "").split(",")):
        cfg = dataclasses.replace(cfg, **OPT_FIELDS[o])
    return cfg


def analyze_cell(arch: str, shape_name: str, *, multi_pod: bool = False, opts: str = "",
                 cfg=None, shape=None, mesh_shape=None) -> dict:
    """One cell → its result dict (written to the artifacts).  Runs on the
    fake world that ``mesh_shape`` (default: the production mesh) needs,
    which the caller has initialised; ``cfg`` and ``shape`` replace the
    named config and shape cell (a reduced model, a smaller cell).  The
    axis names are the production mesh's of the same rank."""
    mesh_shape = tuple(mesh_shape or MESHES[multi_pod][0])
    axes = MESHES[len(mesh_shape) == 3][1]
    cfg = apply_opts(cfg or get_config(arch), opts)
    shape = shape or SHAPES[shape_name]
    mesh = Mesh(mesh_shape, axes)
    n_dev = mesh.size
    out: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh_shape), "opts": opts}
    m = measure_cell(cfg, shape, mesh)
    coll_total = float(sum(m["collectives"].values()))
    out.update(
        compile_seconds=round(m["seconds"], 1),
        per_device_bytes=m["per_device_bytes"],
        per_device_gib=round(m["per_device_bytes"] / 2**30, 3),
        argument_bytes=m["argument_bytes"],
        raw_flops=m["flops"], raw_bytes=m["bytes"],
        raw_collectives=dict(m["collectives"], total=coll_total),
    )
    bf16 = cfg.dtype == "bfloat16"
    analysis = CellAnalysis(
        arch=arch, shape=shape_name, mesh=out["mesh"],
        flops=m["flops"], bytes_accessed=m["bytes"], collective_bytes=coll_total,
        collective_breakdown=dict(m["collectives"]),
        per_device_memory=m["per_device_bytes"],
        model_flops=model_flops_estimate(cfg, shape) / n_dev,
        peak_flops=PEAK_FLOPS if bf16 else PEAK_FLOPS_F32,
    )
    out["analysis"] = analysis.to_dict()
    out["method"] = "fake-tensor run of the whole depth (rank 0 of a fake process group)"
    return out


# --------------------------------------------------------------------------
# GP cells (the paper's own technique at pod scale)
# --------------------------------------------------------------------------


def gp_cell(arch: str, *, multi_pod: bool = False, opts: str = "") -> dict:
    """Distributed BBMM exact-GP MLL training step, n row-sharded over every
    axis — the reference's analytic terms with the port's constants.  The
    step's CG loop stops on values (its convergence test reads them), so it
    cannot run on fake tensors: the memory is analytic too.

    opts: "bf16" computes kernel tiles in bf16 (f32 accumulate) and gathers
    M in bf16."""
    bf16 = "bf16" in (opts or "")
    shape, _ = MESHES[multi_pod]
    n_chips = 1
    for s in shape:
        n_chips *= s
    n, d = (2_097_152, 8) if arch == "gp-exact-2m" else (8_388_608, 8)
    t, p = 10, 20  # paper defaults
    cols = t + 1  # probe block + y
    n_loc = n / n_chips
    matmul_passes = p + 2  # + backward: one vjp matmul + precond work
    flops = matmul_passes * (2.0 * n_loc * n * (d + cols) + 6.0 * n_loc * n)
    byts = matmul_passes * 4.0 * (n * d + 2.0 * n * cols + 2.0 * n_loc * cols)
    elt = 2.0 if bf16 else 4.0
    coll = matmul_passes * elt * n * cols
    model_flops = matmul_passes * 2.0 * n_loc * n * (d + cols)
    # X and y whole on every rank, the gathered M, the rank's CG state and
    # its Lanczos coefficients (p iterations of its rows)
    mem = int(4 * (n * d + n) + elt * n * cols + 4 * n_loc * cols * (p + 4))
    analysis = CellAnalysis(
        arch=arch, shape="mll_step", mesh=mesh_name(shape),
        flops=flops, bytes_accessed=byts, collective_bytes=coll,
        collective_breakdown={"all-gather": coll}, per_device_memory=mem,
        model_flops=model_flops, peak_flops=PEAK_FLOPS if bf16 else PEAK_FLOPS_F32,
    )
    return {"arch": arch, "shape": "mll_step", "mesh": mesh_name(shape), "opts": opts,
            "per_device_bytes": mem, "per_device_gib": round(mem / 2**30, 3),
            "analysis": analysis.to_dict(), "method": "analytic"}


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def port_frames(tb, limit: int = 12) -> list:
    """The innermost ``limit`` frames of ``tb`` that lie in this package,
    innermost last, as "repro_torch/path.py:line in function: code" — the
    port's lines that a deep DTensor error's traceback tail leaves out."""
    out = []
    for f in traceback.extract_tb(tb):
        parts = f.filename.replace(os.sep, "/").split("/repro_torch/")
        if len(parts) > 1:
            out.append(f"repro_torch/{parts[-1]}:{f.lineno} in {f.name}: {f.line}")
    return out[-limit:]


def run_one(arch, shape_name, multi_pod, outdir, opts=""):
    tag = f"{arch}_{shape_name}_{'2x16x16' if multi_pod else '16x16'}"
    if opts:
        tag += "_" + opts.replace(",", "+")
    path = os.path.join(outdir, tag + ".json")
    try:
        if arch in GP_ARCHS:
            result = gp_cell(arch, multi_pod=multi_pod, opts=opts)
        else:
            result = analyze_cell(arch, shape_name, multi_pod=multi_pod, opts=opts)
        result["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — the cell's status and traceback go to its artifact
        result = {
            "arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16",
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
            "port_frames": port_frames(e.__traceback__),
        }
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2, default=str)
    status = result["status"]
    print(f"[{status}] {tag}  mem/dev={result.get('per_device_gib', '-')} GiB  "
          f"({result.get('compile_seconds', '-')}s)", flush=True)
    if status == "ok":
        a = result["analysis"]
        print(f"    t_comp={a['t_compute']:.4f}s t_mem={a['t_memory']:.4f}s "
              f"t_coll={a['t_collective']:.4f}s  bottleneck={a['bottleneck']} "
              f"useful={a['useful_ratio']:.2f}", flush=True)
    return result


def _world(multi_pod):
    n = 1
    for s in MESHES[multi_pod][0]:
        n *= s
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--gp", action="store_true", help="run the GP paper cells")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--opt", default="", help="comma list: chunked,sp,bf16grad")
    args = ap.parse_args(argv)

    if args.all or args.gp:
        for mp in (False, True):
            with fake_world(_world(mp)):
                if args.all:
                    for arch in ALL_ARCHS:
                        for shape in runnable_shapes(get_config(arch)):
                            run_one(arch, shape.name, mp, args.out)
                for arch in GP_ARCHS:
                    run_one(arch, "mll_step", mp, args.out)
        return 0
    if not args.arch:
        ap.error("--arch required (or --all / --gp)")
    if args.arch in GP_ARCHS:
        result = run_one(args.arch, "mll_step", args.multi_pod, args.out, opts=args.opt)
        return 0 if result["status"] == "ok" else 1
    shapes = [args.shape] if args.shape else [s.name for s in runnable_shapes(get_config(args.arch))]
    with fake_world(_world(args.multi_pod)):
        results = [run_one(args.arch, s, args.multi_pod, args.out, opts=args.opt) for s in shapes]
    return 0 if all(r["status"] == "ok" for r in results) else 1


if __name__ == "__main__":
    raise SystemExit(main())

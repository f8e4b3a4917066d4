"""The port's multi-device GP path on a world of 4 ranks (gloo, CPU) against
the reference's single-device functions (counterparts of
tests/test_multidevice.py:34-200, :308-470).

The reference runs its multi-device tests on 8 forced XLA devices in
``python -c`` subprocesses.  The port's counterpart, :func:`run_with_ranks`,
writes the ranks' body to a script and runs it in one subprocess, which
starts the world with :func:`repro_torch.distributed.spawn_world` (one
torch thread a rank, ``file://`` rendezvous, a 120 s timeout) and saves
rank 0's results to an ``.npz``; the ranks import ``repro_torch`` and no
JAX.  Every rank must return the same bits (the global view: each rank
computes its row band and gathers the rest), which the subprocess asserts.
This module spawns ONE world (a 4-rank spawn costs seconds here) that runs
every check; the tests below compare its results with the reference's
single-device functions, computed here on the same numpy inputs and with
the reference's Rademacher draws replayed into the ranks.

The meshes: (4,) ``("data",)`` where the reference uses (8,) or (4,), and
(2, 2) ``("data", "model")`` with rows sharded over "data" where it uses
(4, 2).  Tolerances are the reference tests'.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import AddedDiagOperator as RefAdded
from repro.core import BBMMSettings as RefSettings
from repro.core import KroneckerAddedDiagOperator as RefKronAdded
from repro.core import KroneckerKernelOperator as RefKron
from repro.core import build_preconditioner as ref_build_preconditioner
from repro.core import engine_state as ref_engine_state
from repro.core import marginal_log_likelihood as ref_mll
from repro.core import mbcg as ref_mbcg
from repro.core import pivoted_cholesky_dense as ref_pivoted_cholesky_dense
from repro.core import solve as ref_solve
from repro.core.mbcg import xla_cg_step
from repro.gp import KernelOperator as RefKernelOperator
from repro.gp import MaternKernel as RefMatern
from repro.gp import RBFKernel as RefRBF
from repro.kernels.kernel_matmul.ops import fused_kernel_matmul as ref_fused_kernel_matmul

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 120

_MAIN = """

if __name__ == "__main__":
    import sys
    from repro_torch.distributed import spawn_world

    _outs = spawn_world(body, {world}, "gloo", args=(sys.argv[1],), timeout={timeout},
                        threads=1)
    for _rank, _out in enumerate(_outs[1:], 1):
        for _k, _v in _out.items():
            assert np.array_equal(_v, _outs[0][_k], equal_nan=True), (_k, _rank)
    np.savez(os.path.join(sys.argv[1], "out.npz"), **_outs[0])
"""


def run_with_ranks(body: str, world: int, inputs: dict, workdir: Path,
                   timeout: int = TIMEOUT) -> dict:
    """Run ``body`` (source defining ``body(rank, world, workdir)``, which
    reads ``in.npz`` from ``workdir`` and returns a dict of numpy arrays) on
    ``world`` gloo ranks in one subprocess; rank 0's dict, after checking
    that every other rank returned the same bits for each of its keys
    (single-device oracles run on rank 0 alone)."""
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "in.npz", **inputs)
    script = workdir / "world.py"
    script.write_text("import os\nimport numpy as np\n" + textwrap.dedent(body)
                      + _MAIN.format(world=world, timeout=timeout))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(script), str(workdir)], capture_output=True,
                          text=True, env=env, timeout=timeout + 60)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    with np.load(workdir / "out.npz") as f:
        return {k: f[k] for k in f.files}


BODY = '''
import contextlib
import threading
import warnings
import torch
import repro_torch.core.preconditioner as port_precond
from repro_torch.core import (AddedDiagOperator, BBMMSettings, DenseOperator,
                              KroneckerAddedDiagOperator, KroneckerKernelOperator,
                              ShardedKernelOperator, build_preconditioner, engine_state,
                              marginal_log_likelihood, mbcg, pivoted_cholesky_sharded,
                              plain_cg_step, solve)
from repro_torch.distributed import (collective_counts, make_mesh, reset_collective_counts,
                                     use_mesh)
from repro_torch.gp import ExactGP, KernelOperator, MaternKernel, MultitaskGP, RBFKernel
from repro_torch.kernels.kernel_matmul.ops import (sharded_kernel_matmul,
                                                   sharded_kernel_matmul_prescaled)


_RADEMACHER = port_precond._rademacher


def replay(draws):
    """The port's next Rademacher draws replaced, in order, by the
    reference's; the port's own draws come back after the last one."""
    queue = [torch.from_numpy(d) for d in draws]

    def rademacher(generator, shape, dtype, device):
        g = queue.pop(0)
        assert tuple(g.shape) == tuple(shape), (g.shape, shape)
        if not queue:
            port_precond._rademacher = _RADEMACHER
        return g.to(device=device, dtype=dtype)

    port_precond._rademacher = rademacher


def body(rank, world, workdir):
    warnings.simplefilter("ignore")
    f = np.load(os.path.join(workdir, "in.npz"))
    T = lambda k: torch.from_numpy(f[k])
    s32 = lambda v: torch.tensor(v, dtype=torch.float32)
    out = {}
    mesh22 = make_mesh((2, 2), ("data", "model"))
    mesh4 = make_mesh((4,), ("data",))
    X64, M64, y64, X96, M96 = T("X64"), T("M64"), T("y64"), T("X96"), T("M96")

    # :34-53 ShardedKernelOperator against the dense matmul
    kern = RBFKernel(s32(0.5), s32(1.2))
    with use_mesh(mesh22):
        out["sko"] = ShardedKernelOperator(kern, X64, data_axes=("data",), chunk=16).matmul(M64)

    # :55-87 the MLL gradient in the lengthscale, sharded (the plain
    # operator and mode="cuda_sharded") against the dense jax.grad
    s = BBMMSettings(num_probes=8, max_cg_iters=64, precond_rank=0, cg_tol=1e-9)
    for name, make in (("sko", lambda k: ShardedKernelOperator(k, X64, chunk=16)),
                       ("cuda", lambda k: KernelOperator(k, X64, mode="cuda_sharded"))):
        ell = s32(0.7).requires_grad_()
        with use_mesh(mesh4):
            replay([f["Z_mll"]])
            mll = marginal_log_likelihood(AddedDiagOperator(make(RBFKernel(ell, s32(1.0))), 0.1),
                                          y64, torch.Generator(), s)
            mll.backward()
        out["mll_" + name], out["mll_grad_" + name] = mll.detach(), ell.grad
    # the backward on another thread than the forward, as autograd runs
    # CUDA backwards: the forward's ambient mesh must reach it
    ell = s32(0.7).requires_grad_()
    with use_mesh(mesh4):
        replay([f["Z_mll"]])
        mll = marginal_log_likelihood(
            AddedDiagOperator(KernelOperator(RBFKernel(ell, s32(1.0)), X64, mode="cuda_sharded"),
                              0.1), y64, torch.Generator(), s)
    worker = threading.Thread(target=mll.backward)
    worker.start()
    worker.join()
    out["mll_grad_thread"] = ell.grad

    # :89-123 RBF, ARD and Matern-5/2 through the sharded kernel path
    kernels = [RBFKernel(s32(0.5), s32(1.2)), RBFKernel(T("ard"), s32(0.9)),
               MaternKernel(s32(0.7), s32(1.0), nu=2.5)]
    for i, k in enumerate(kernels):
        out[f"kern{i}"] = sharded_kernel_matmul(k, X96, M96, mesh4, ("data",))
        with use_mesh(mesh4):
            out[f"kern{i}_op"] = KernelOperator(k, X96, mode="cuda_sharded").matmul(M96)

    # :125-172 the sharded pivoted Cholesky, the auto-wired preconditioner
    # and MLL, and an n the shards do not divide
    with use_mesh(mesh4):
        out["pc_L"] = pivoted_cholesky_sharded(DenseOperator(T("K96")), 6)
        op = AddedDiagOperator(KernelOperator(kern, X96, mode="dense"), 0.1)
        out["P_L"] = build_preconditioner(op, 5).L
        if rank == 0:
            out["P_rep_L"] = build_preconditioner(op, 5, shard=False).L
        s5 = BBMMSettings(num_probes=8, max_cg_iters=64, precond_rank=5, cg_tol=1e-9)
        replay([f["g1"], f["g2"]])
        out["mll_precond_sharded"] = marginal_log_likelihood(op, T("y96"), torch.Generator(), s5)
        op97 = AddedDiagOperator(KernelOperator(kern, T("X97"), mode="dense"), 0.1)
        out["P97_shape"] = np.array(build_preconditioner(op97, 4).L.shape)
        try:
            sharded_kernel_matmul_prescaled(T("X97"), T("X97"), 1.0, mesh4)
            out["uneven_raises"] = np.array(False)
        except ValueError as e:
            out["uneven_raises"] = np.array("divide evenly" in str(e))
    if rank == 0:
        replay([f["g1"], f["g2"]])
        out["mll_precond_replicated"] = marginal_log_likelihood(op, T("y96"), torch.Generator(),
                                                                s5)

    # :174-200 the engine's MLL through mode="cuda_sharded"
    k07 = RBFKernel(s32(0.7), s32(1.0))
    with use_mesh(mesh4):
        replay([f["Z_mll"]])
        out["mll_e2e"] = marginal_log_likelihood(
            AddedDiagOperator(KernelOperator(k07, X64, mode="cuda_sharded"), 0.1), y64,
            torch.Generator(), s)

    # :308-362 bf16 (mixed) and batched right-hand sides; the bf16 plain
    # sharded operator against its f32 self
    k10 = RBFKernel(s32(0.5), s32(1.0))
    with use_mesh(mesh4):
        op = KernelOperator(k10, X64, mode="cuda_sharded")
        out["mixed"] = op.with_compute_dtype("mixed").matmul(T("M64_4"))
        out["batched"] = op.matmul(T("Mb"))
        out["sko_f32"] = ShardedKernelOperator(k10, X64, chunk=16).matmul(T("M64_4"))
        out["sko_bf16"] = ShardedKernelOperator(k10, X64, chunk=16,
                                                compute_dtype="bfloat16").matmul(T("M64_4"))

    # :368-420 the sharded fused step against the plain step, and the fused
    # engine against the unfused one (a batched right-hand side too)
    with use_mesh(mesh22):
        op = AddedDiagOperator(KernelOperator(kern, X64, mode="cuda_sharded",
                                              data_axes=("data",)), 0.1)
        prepared = op.prepare()
        step = prepared.fused_cg_step_fn()
        args = [T(k) for k in ("U", "R", "D", "V", "al", "be", "ga")]
        reset_collective_counts()
        got = step(*args)
        c = collective_counts()
        out["step_collectives"] = np.array([c["all_gathers"], c["gathered_bytes"]])
        for i, x in enumerate(got[:4]):
            out[f"step{i}"] = x
        for i, x in enumerate(got[4]):
            out[f"step_red{i}"] = x
        for i, x in enumerate(plain_cg_step(prepared.matmul)(*args)[4]):
            out[f"plain_red{i}"] = x  # the plain step over the sharded matmul
        reset_collective_counts()
        prepared.matmul(M64)
        c = collective_counts()
        out["matmul_collectives"] = np.array([c["all_gathers"], c["gathered_bytes"]])
        s0 = BBMMSettings(num_probes=6, max_cg_iters=48, precond_rank=0, cg_tol=1e-6)
        sf = BBMMSettings(num_probes=6, max_cg_iters=48, precond_rank=0, cg_tol=1e-6,
                          fuse_cg=True)
        replay([f["Z_eng"], f["Z_eng"]])
        out["solve_unfused"] = engine_state(op, y64, torch.Generator(), s0).solve_y
        out["solve_fused"] = engine_state(op, y64, torch.Generator(), sf).solve_y
        B = torch.stack([torch.stack([y64, -y64], -1), torch.stack([2 * y64, y64 * y64], -1)])
        out["mbcg_fused"] = mbcg(prepared.matmul, B, max_iters=48, tol=1e-6,
                                 fused_step=step).solves
        out["mbcg_unfused"] = mbcg(prepared.matmul, B, max_iters=48, tol=1e-6).solves

    # :423-470 the Kronecker multitask operator with a row-sharded data kernel
    k11 = RBFKernel(s32(0.5), s32(1.1))
    KT, noise = T("KT"), T("noise")
    with use_mesh(mesh4):
        mt = KroneckerAddedDiagOperator(
            KroneckerKernelOperator(KernelOperator(k11, X64, mode="cuda_sharded"), KT), noise)
        out["kron"] = mt.matmul(T("Mmt"))
        out["kron_prepared"] = mt.prepare().matmul(T("Mmt"))
        sm = BBMMSettings(num_probes=4, max_cg_iters=60, cg_tol=1e-6, precond_rank=0)
        out["kron_solve"] = solve(mt, T("ylong")[:, None], sm)
        # MultitaskGP(mode="cuda_sharded") against mode="cuda", one loss
        for mode in ("cuda_sharded", "cuda")[: 2 if rank == 0 else 1]:
            gp = MultitaskGP(num_tasks=4, mode=mode, device="cpu", settings=sm)
            data = gp.prepare_inputs(T("Xlong"))
            params = gp.init_params(T("Xlong"), generator=torch.Generator().manual_seed(0))
            out["mt_loss_" + mode] = gp.loss(params, data, T("ylong"),
                                            torch.Generator().manual_seed(1))

    # ExactGP(mode="cuda_sharded").fit: two Adam steps against mode="cuda"
    # (the preconditioner built sharded at rank 5; the fused step at rank 0)
    for name, st in (("rank5", BBMMSettings(num_probes=4, max_cg_iters=5, cg_tol=1e-12,
                                            precond_rank=5)),
                     ("fused", BBMMSettings(num_probes=4, max_cg_iters=5, cg_tol=1e-12,
                                            precond_rank=0, fuse_cg=True))):
        for mode in ("cuda_sharded", "cuda")[: 2 if rank == 0 else 1]:
            gp = ExactGP(kernel_type="matern52", mode=mode, settings=st, device="cpu")
            # the single-device fit off the mesh: under it, its preconditioner
            # would be built sharded, a collective the other ranks never join
            with use_mesh(mesh4) if mode == "cuda_sharded" else contextlib.nullcontext():
                params, hist = gp.fit(X64, y64, steps=2, lr=0.1,
                                      generator=torch.Generator().manual_seed(3))
            out[f"fit_{name}_{mode}"] = torch.tensor(hist)
            out[f"fit_{name}_{mode}_ell"] = params["raw_lengthscale"].detach()
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
'''


def _rad(key, shape):
    return np.array(jax.random.rademacher(key, shape, dtype=jnp.float32))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    X64, M64, X96, M96 = f32(64, 3), f32(64, 5), f32(96, 3), f32(96, 5)
    Bt = 0.4 * f32(4, 2)
    KT = (Bt @ Bt.T + np.eye(4)).astype(np.float32)
    y64 = np.sin(X64 @ np.ones(3, np.float32)).astype(np.float32)
    X97 = f32(97, 3)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    # a multitask panel in the long format: 64 locations × 4 tasks
    ylong = np.tile(y64[:, None], (1, 4)).reshape(-1).astype(np.float32)
    Xlong = np.concatenate([np.repeat(X64, 4, axis=0),
                            np.tile(np.arange(4, dtype=np.float32), 64)[:, None]], axis=1)
    inputs = dict(
        X64=X64, M64=M64, y64=y64, X96=X96, M96=M96, X97=X97,
        y96=np.sin(X96 @ np.ones(3, np.float32)).astype(np.float32),
        ard=np.array([0.3, 0.8, 1.5], np.float32),
        K96=np.asarray(RefRBF(jnp.float32(0.5), jnp.float32(1.2))(X96, X96)),
        Z_mll=_rad(jax.random.PRNGKey(1), (64, 8)), g1=_rad(k1, (5, 8)), g2=_rad(k2, (96, 8)),
        Z_eng=_rad(jax.random.PRNGKey(7), (64, 6)),
        M64_4=f32(64, 4), Mb=f32(2, 64, 4),
        U=f32(64, 5), R=f32(64, 5), D=f32(64, 5), V=f32(64, 5), al=f32(5),
        be=(0.3 * f32(5)).astype(np.float32), ga=np.ones(5, np.float32),
        KT=KT, noise=(0.1 + 0.1 * np.arange(4)).astype(np.float32), Mmt=f32(256, 5),
        ylong=ylong, Xlong=Xlong,
    )
    out = run_with_ranks(BODY, WORLD, inputs, tmp_path_factory.mktemp("sharded_world"))
    return inputs, out


def _dense(ell, s, X, kind="rbf"):
    kern = (RefRBF if kind == "rbf" else RefMatern)(lengthscale=ell, outputscale=jnp.float32(s))
    return RefKernelOperator(kernel=kern, X=jnp.asarray(X), mode="dense")


def test_sharded_kernel_operator_matches_dense(world):
    inp, out = world
    ref = _dense(jnp.float32(0.5), 1.2, inp["X64"]).matmul(jnp.asarray(inp["M64"]))
    np.testing.assert_allclose(out["sko"], np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_distributed_mll_grad_matches_single_device(world):
    """The reference's failing step-16 behaviour, held by the port: the MLL
    gradient through the sharded operators equals the dense one, also with
    the backward on another thread than the forward (as autograd runs the
    backward of CUDA tensors)."""
    inp, out = world
    s = RefSettings(num_probes=8, max_cg_iters=64, precond_rank=0, cg_tol=1e-9)

    def mll_dense(ell):
        op = RefAdded(_dense(ell, 1.0, inp["X64"]), 0.1)
        return ref_mll(op, jnp.asarray(inp["y64"]), jax.random.PRNGKey(1), s)

    mll, g = jax.value_and_grad(mll_dense)(jnp.float32(0.7))
    for name in ("sko", "cuda"):
        np.testing.assert_allclose(out["mll_" + name], float(mll), rtol=1e-4)
        np.testing.assert_allclose(out["mll_grad_" + name], float(g), rtol=2e-3)
    np.testing.assert_array_equal(out["mll_grad_thread"], out["mll_grad_cuda"])


def test_sharded_cuda_matmul_matches_single_device(world):
    """RBF, ARD RBF and Matern-5/2: the sharded product (the function and the
    operator under the ambient mesh) against the reference's single-device
    fused kernel matmul, 1e-5."""
    inp, out = world
    cases = [(jnp.float32(0.5), 1.2, "rbf"), (jnp.asarray(inp["ard"]), 0.9, "rbf"),
             (jnp.float32(0.7), 1.0, "matern52")]
    for i, (ell, s, kt) in enumerate(cases):
        ref = np.asarray(ref_fused_kernel_matmul(
            jnp.asarray(inp["X96"]), jnp.asarray(inp["M96"]), ell, jnp.float32(s),
            jnp.float32(0.0), kernel_type=kt))
        for key in (f"kern{i}", f"kern{i}_op"):
            np.testing.assert_allclose(out[key], ref, rtol=1e-5, atol=1e-5, err_msg=key)


def test_sharded_pivoted_cholesky_matches_replicated(world):
    """The reference's failing step-16 behaviour, held by the port: the
    row-sharded pivoted Cholesky equals the replicated build, standalone and
    auto-wired through build_preconditioner into the engine; an n the shards
    do not divide stays replicated."""
    inp, out = world
    L_ref = np.asarray(ref_pivoted_cholesky_dense(jnp.asarray(inp["K96"]), 6))
    np.testing.assert_allclose(out["pc_L"], L_ref, atol=1e-5)
    np.testing.assert_allclose(out["P_L"], out["P_rep_L"], atol=1e-5)
    op = RefAdded(_dense(jnp.float32(0.5), 1.2, inp["X96"]), 0.1)
    np.testing.assert_allclose(out["P_L"], np.asarray(ref_build_preconditioner(op, 5).L),
                               atol=1e-5)
    s5 = RefSettings(num_probes=8, max_cg_iters=64, precond_rank=5, cg_tol=1e-9)
    mll = float(ref_mll(op, jnp.asarray(inp["y96"]), jax.random.PRNGKey(1), s5))
    np.testing.assert_allclose(out["mll_precond_sharded"], out["mll_precond_replicated"],
                               rtol=1e-4)
    np.testing.assert_allclose(out["mll_precond_sharded"], mll, rtol=1e-4)
    assert tuple(out["P97_shape"]) == (97, 4)
    assert bool(out["uneven_raises"])


def test_sharded_cuda_mll_end_to_end(world):
    inp, out = world
    s = RefSettings(num_probes=8, max_cg_iters=64, precond_rank=0, cg_tol=1e-9)
    mll = ref_mll(RefAdded(_dense(jnp.float32(0.7), 1.0, inp["X64"]), 0.1),
                  jnp.asarray(inp["y64"]), jax.random.PRNGKey(1), s)
    np.testing.assert_allclose(out["mll_e2e"], float(mll), rtol=1e-4)


def test_cuda_sharded_mixed_and_batched(world):
    """bf16 operands within CG-recoverable distance (0.02 relative) of the
    f32 dense product; a batched (b, n, t) right-hand side through B2 on
    every band, 5e-4."""
    inp, out = world
    dense = _dense(jnp.float32(0.5), 1.0, inp["X64"])
    ref = np.asarray(dense.matmul(jnp.asarray(inp["M64_4"])))
    rel = np.linalg.norm(out["mixed"] - ref) / np.linalg.norm(ref)
    assert rel < 0.02, rel
    assert out["batched"].shape == (2, 64, 4)
    np.testing.assert_allclose(out["batched"], np.asarray(dense.matmul(jnp.asarray(inp["Mb"]))),
                               rtol=5e-4, atol=5e-4)


def test_bf16_sharded_operator_close_to_f32(world):
    _, out = world
    rel = np.linalg.norm(out["sko_bf16"] - out["sko_f32"]) / np.linalg.norm(out["sko_f32"])
    assert rel < 0.02, rel


def test_sharded_fused_step_and_engine(world):
    """The sharded fused step against the reference's plain step on its
    dense operator (state 2e-4, reductions 2e-3), the fused engine against
    the unfused one (1e-3 / 1e-4) and against the reference's engine, a
    batched right-hand side too; one all-gather per product, two per fused
    step (the four bands, the reductions' fold)."""
    inp, out = world
    op = RefAdded(_dense(jnp.float32(0.5), 1.2, inp["X64"]), 0.1)
    args = [jnp.asarray(inp[k]) for k in ("U", "R", "D", "V", "al", "be", "ga")]
    ref = xla_cg_step(op.matmul)(*args)
    for i in range(4):
        np.testing.assert_allclose(out[f"step{i}"], np.asarray(ref[i]), rtol=2e-4, atol=2e-4)
    for i in range(4):
        np.testing.assert_allclose(out[f"step_red{i}"], np.asarray(ref[4][i]), rtol=2e-4,
                                   atol=2e-3)
        np.testing.assert_allclose(out[f"step_red{i}"], out[f"plain_red{i}"], rtol=2e-4,
                                   atol=2e-3)
    np.testing.assert_allclose(out["solve_fused"], out["solve_unfused"], rtol=1e-3, atol=1e-4)
    s0 = RefSettings(num_probes=6, max_cg_iters=48, precond_rank=0, cg_tol=1e-6)
    st = ref_engine_state(op, jnp.asarray(inp["y64"]), jax.random.PRNGKey(7), s0)
    np.testing.assert_allclose(out["solve_unfused"], np.asarray(st.solve_y), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out["mbcg_fused"], out["mbcg_unfused"], rtol=1e-3, atol=1e-4)
    y = jnp.asarray(inp["y64"])
    B = jnp.stack([jnp.stack([y, -y], -1), jnp.stack([2 * y, y * y], -1)])
    ru = ref_mbcg(op.matmul, B, max_iters=48, tol=1e-6)
    np.testing.assert_allclose(out["mbcg_unfused"], np.asarray(ru.solves), rtol=1e-3, atol=1e-4)
    n, t, shards = 64, 5, 2
    assert tuple(out["matmul_collectives"]) == (1, n * t * 4)
    assert tuple(out["step_collectives"]) == (2, 4 * n * t * 4 + shards * 4 * t * 4)


def test_kronecker_sharded_data_kernel(world):
    """The Kronecker multitask operator with a row-sharded data kernel
    against the reference's dense one (5e-4), prepared too; the engine
    solve through it (1e-3); MultitaskGP(mode="cuda_sharded")'s loss
    against mode="cuda" (1e-4)."""
    inp, out = world
    kern = RefRBF(lengthscale=jnp.float32(0.5), outputscale=jnp.float32(1.1))
    ref_op = RefKronAdded(RefKron(RefKernelOperator(kernel=kern, X=jnp.asarray(inp["X64"]),
                                                    mode="dense"), jnp.asarray(inp["KT"])),
                          jnp.asarray(inp["noise"]))
    ref = np.asarray(ref_op.matmul(jnp.asarray(inp["Mmt"])))
    for key in ("kron", "kron_prepared"):
        np.testing.assert_allclose(out[key], ref, rtol=5e-4, atol=5e-4, err_msg=key)
    s = RefSettings(num_probes=4, max_cg_iters=60, cg_tol=1e-6, precond_rank=0)
    sol = ref_solve(ref_op, jnp.asarray(inp["ylong"])[:, None], s)
    np.testing.assert_allclose(out["kron_solve"], np.asarray(sol), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out["mt_loss_cuda_sharded"], out["mt_loss_cuda"], rtol=1e-4)


@pytest.mark.parametrize("settings", ["rank5", "fused"])
def test_exact_gp_cuda_sharded_fit_matches_cuda(world, settings):
    """ExactGP(mode="cuda_sharded").fit trains: two Adam steps over a
    5-iteration CG prefix against mode="cuda" from the same probes (losses
    rtol 1e-4, the lengthscale after the steps 1e-4) — at precond_rank=5
    with the factor built sharded, and fused at rank 0."""
    _, out = world
    a, b = f"fit_{settings}_cuda_sharded", f"fit_{settings}_cuda"
    assert np.isfinite(out[a]).all() and out[a].shape == (2,)
    np.testing.assert_allclose(out[a], out[b], rtol=1e-4)
    np.testing.assert_allclose(out[a + "_ell"], out[b + "_ell"], rtol=1e-4)

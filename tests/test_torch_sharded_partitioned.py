"""The port's partitioned path sharded over a world of 8 ranks (gloo, CPU):
row bands of panels, the panel-fused engine bitwise between 1 and 8 ranks,
and the band-sharded backward (counterparts of
tests/test_partitioned.py:279-330 and :515-660, whose two sharded-fused
tests fail on the reference's jax pin).

One world of 8 ranks (:func:`test_torch_sharded.run_with_ranks`) runs every
check and returns rank 0's results (every rank's are asserted identical).
Each sharded result is held bitwise, or at the reference test's tolerance,
to the port's own single-device path computed in the same rank, on both
backends ("cuda": the kernel wrappers, whose plain versions run on CPU
tensors; "torch": plain panels); the single-device path is held to the
reference's (its "xla" backend, dense ``jax.grad``) at the existing
partitioned tolerances, on the same numpy inputs with the reference's
Rademacher draws replayed into the ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_sharded import run_with_ranks

from repro.core import BBMMSettings as RefSettings
from repro.core import PartitionedKernelOperator as RefPartitioned
from repro.gp import ExactGP as RefExactGP
from repro.gp import KernelOperator as RefKernelOperator
from repro.gp import RBFKernel as RefRBF

jax.config.update("jax_platform_name", "cpu")
pytestmark = pytest.mark.partitioned

WORLD = 8
BACKENDS = ("cuda", "torch")
TOL = dict(rtol=1e-4, atol=1e-4)

BODY = '''
import warnings
import torch
import repro_torch.core.preconditioner as port_precond
from repro_torch.core import (AddedDiagOperator, BBMMSettings, PartitionedKernelOperator,
                              collect, engine_state, panel_accounting)
from repro_torch.distributed import make_mesh, use_mesh
from repro_torch.gp import ExactGP, RBFKernel


def probes(Z):
    """Every engine call draws the reference's probes Z."""
    port_precond.IdentityPreconditioner.sample_probes = (
        lambda self, generator, num, n: torch.from_numpy(Z).clone())


def body(rank, world, workdir):
    warnings.simplefilter("ignore")
    f = np.load(os.path.join(workdir, "in.npz"))
    T = lambda k: torch.from_numpy(f[k])
    s32 = lambda v: torch.tensor(v, dtype=torch.float32)
    out = {}
    mesh = make_mesh((world,), ("data",))
    kern = RBFKernel(s32(0.7), s32(1.3))
    X768, M768, X512, M512, M512_2 = T("X768"), T("M768"), T("X512"), T("M512"), T("M512_2")

    # :279-306 panel bands against single-device streaming, bitwise
    for backend in ("cuda", "torch"):
        ref = PartitionedKernelOperator(kern, X768, panel_rows=100, backend=backend,
                                        data_axes=()).matmul(M768)
        sharded = PartitionedKernelOperator(kern, X768, panel_rows=100, backend=backend,
                                            mesh=mesh)
        with panel_accounting() as launches:
            got = sharded.matmul(M768)
        out[f"panel_single_{backend}"] = ref
        out[f"panel_equal_{backend}"] = np.array(torch.equal(got, ref))
        out[f"panel_record_{backend}"] = np.array(
            [launches[0].sharded, launches[0].devices, launches[0].num_panels,
             launches[0].panel_rows])

    # :308-330 the ambient mesh shards too
    op = PartitionedKernelOperator(kern, X512, panel_rows=64, backend="torch")
    ref = op.matmul(M512_2)
    with use_mesh(mesh):
        with panel_accounting() as launches:
            got = op.matmul(M512_2)
    out["ambient_equal"] = np.array(torch.equal(got, ref))
    out["ambient_record"] = np.array([launches[0].sharded, launches[0].devices])

    # :522-567 the panel-fused engine (y + 2 probes, 25 iterations): solves
    # and logdet bitwise between 1 and 8 ranks, one 96-row panel per band
    probes(f["Z_eng"])
    s = BBMMSettings(num_probes=2, max_cg_iters=25, precond_rank=0, cg_tol=1e-4, fuse_cg=True)
    y = torch.sin(X768[:, 0])
    for backend in ("cuda", "torch"):
        res = []
        for kw in (dict(data_axes=()), dict(mesh=mesh))[1 if rank else 0:]:
            op = AddedDiagOperator(PartitionedKernelOperator(kern, X768, panel_rows=96,
                                                             backend=backend, **kw), 0.5)
            with collect() as reports:
                st = engine_state(op, y, torch.Generator(), s)
            res.append((st, reports[-1].status))
        out[f"eng_solve8_{backend}"], out[f"eng_logdet8_{backend}"] = res[-1][0].solve_y, \
            res[-1][0].logdet
        if rank:
            continue
        (st1, status1), (st8, status8) = res
        out[f"eng_status_equal_{backend}"] = np.array(status1 == status8)
        out[f"eng_solve_equal_{backend}"] = np.array(torch.equal(st1.solve_y, st8.solve_y))
        out[f"eng_logdet_equal_{backend}"] = np.array(float(st1.logdet) == float(st8.logdet))
        # one rank's engine over a 5-iteration prefix, for the reference
        op = AddedDiagOperator(PartitionedKernelOperator(kern, X768, panel_rows=96,
                                                         backend=backend, data_axes=()), 0.5)
        st = engine_state(op, y, torch.Generator(), BBMMSettings(
            num_probes=2, max_cg_iters=5, precond_rank=0, cg_tol=1e-4, fuse_cg=True))
        out[f"eng5_solve_{backend}"], out[f"eng5_logdet_{backend}"] = st.solve_y, st.logdet

    # :569-655 the band-sharded backward: the lengthscale gradient of
    # sum((K M)^2) on 8 ranks and on 1, both backends; the M cotangent
    for backend in ("cuda", "torch"):
        for name, kw in (("8", dict(mesh=mesh)), ("1", dict(data_axes=())))[: 2 if rank == 0
                                                                             else 1]:
            ell = s32(0.7).requires_grad_()
            op = PartitionedKernelOperator(RBFKernel(ell, s32(1.3)), X512, panel_rows=64,
                                           backend=backend, **kw)
            (op.matmul(M512) ** 2).sum().backward()
            out[f"grad_ell_{backend}_{name}"] = ell.grad
        Mg = M512.clone().requires_grad_()
        op = PartitionedKernelOperator(kern, X512, panel_rows=64, backend=backend, mesh=mesh)
        (op.matmul(Mg) ** 2).sum().backward()
        out[f"grad_M_{backend}"] = Mg.grad

    # the MLL gradients through the band-sharded backward (the ambient
    # mesh), unfused and panel-fused, against one rank's
    probes(f["Z_mll"])
    s = BBMMSettings(num_probes=2, max_cg_iters=25, precond_rank=0, panel_rows=64)
    y = torch.sin(X512[:, 0])
    for backend in ("cuda", "torch"):
        for name, fuse, ambient in (("8", False, True), ("fused8", True, True),
                                    ("1", False, False))[: 3 if rank == 0 else 2]:
            gp = ExactGP(mode="cuda_partitioned", panel_backend=backend, device="cpu",
                         settings=BBMMSettings(num_probes=2, max_cg_iters=25, precond_rank=0,
                                               panel_rows=64, fuse_cg=fuse))
            params = {k: T("p_" + k).clone().requires_grad_()
                      for k in ("raw_lengthscale", "raw_outputscale", "raw_noise")}
            if ambient:
                with use_mesh(mesh):
                    loss = gp.loss(params, X512, y, torch.Generator())
            else:
                loss = gp.loss(params, X512, y, torch.Generator())
            loss.backward()
            out[f"mll_{backend}_{name}"] = loss.detach()
            for k, v in params.items():
                out[f"mll_{backend}_{name}_{k}"] = v.grad
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()}
'''


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    X512 = f32(512, 4)
    ref_gp = RefExactGP(mode="pallas_partitioned", panel_backend="xla")
    params = {k: np.asarray(v) for k, v in ref_gp.init_params(X512).items()}
    inputs = dict(
        X768=f32(768, 4), M768=f32(768, 3), X512=X512, M512=f32(512, 2), M512_2=f32(512, 2),
        Z_eng=np.array(jax.random.rademacher(jax.random.PRNGKey(5), (768, 2), dtype=jnp.float32)),
        Z_mll=np.array(jax.random.rademacher(jax.random.PRNGKey(2), (512, 2), dtype=jnp.float32)),
        **{"p_" + k: v for k, v in params.items()},
    )
    out = run_with_ranks(BODY, WORLD, inputs, tmp_path_factory.mktemp("sharded_partitioned"))
    return inputs, out


def _ref_kernel(ell=0.7):
    return RefRBF(lengthscale=jnp.float32(ell), outputscale=jnp.float32(1.3))


@pytest.mark.parametrize("backend", BACKENDS)
def test_panel_bands_bitwise_equal_single_device(world, backend):
    """Eight row bands of panels (96 rows each, panel_rows 100 capped at
    the band) against one rank's 100-row panel stream: bitwise; the
    record says sharded over 8 devices.  The single-device stream against
    the reference's (xla), 1e-4."""
    inp, out = world
    assert bool(out[f"panel_equal_{backend}"])
    assert tuple(out[f"panel_record_{backend}"]) == (1, 8, 8, 96)
    ref = RefPartitioned(kernel=_ref_kernel(), X=jnp.asarray(inp["X768"]), panel_rows=100,
                         backend="xla", data_axes=()).matmul(jnp.asarray(inp["M768"]))
    np.testing.assert_allclose(out[f"panel_single_{backend}"], np.asarray(ref), **TOL)


def test_ambient_mesh_context_shards(world):
    _, out = world
    assert tuple(out["ambient_record"]) == (1, 8)
    assert bool(out["ambient_equal"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_fused_engine_bitwise_1_vs_8_ranks(world, backend):
    """The reference's failing step-16 behaviour, held by the port: the
    panel-fused engine (y + 2 probes, 25 iterations, one panel per band)
    gives the same status, solves and logdet, bit for bit, on 1 and on 8
    ranks; one rank's against the reference's single-device engine on the
    same probes over a 5-iteration prefix (solves 1e-4, logdet rtol 1e-4 /
    atol 1e-3): two correct f32 CG runs part ways after ~10 iterations, so
    across packages the 25-iteration solves are compared no further."""
    inp, out = world
    assert bool(out[f"eng_status_equal_{backend}"])
    assert bool(out[f"eng_solve_equal_{backend}"])
    assert bool(out[f"eng_logdet_equal_{backend}"])
    X = jnp.asarray(inp["X768"])
    from repro.core import AddedDiagOperator, engine_state

    op = AddedDiagOperator(RefPartitioned(kernel=_ref_kernel(), X=X, panel_rows=96,
                                          backend="xla", data_axes=()), 0.5)
    s = RefSettings(num_probes=2, max_cg_iters=5, precond_rank=0, cg_tol=1e-4, fuse_cg=True)
    st = engine_state(op, jnp.sin(X[:, 0]), jax.random.PRNGKey(5), s)
    np.testing.assert_allclose(out[f"eng5_solve_{backend}"], np.asarray(st.solve_y), **TOL)
    np.testing.assert_allclose(out[f"eng5_logdet_{backend}"], float(st.logdet), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_band_sharded_backward_grads(world, backend):
    """The reference's failing step-16 behaviour, held by the port: the
    lengthscale gradient through the band-sharded backward against the
    dense jax.grad (1e-4) and 8 ranks against 1 (1e-5); the M cotangent
    against the dense one (1e-4)."""
    inp, out = world
    X, M = jnp.asarray(inp["X512"]), jnp.asarray(inp["M512"])

    def loss_dense(ell):
        op = RefKernelOperator(kernel=_ref_kernel(ell), X=X, mode="dense")
        return jnp.sum(op.matmul(M) ** 2)

    g_ref = float(jax.grad(loss_dense)(jnp.float32(0.7)))
    g8, g1 = out[f"grad_ell_{backend}_8"], out[f"grad_ell_{backend}_1"]
    np.testing.assert_allclose(g8, g_ref, rtol=1e-4)
    np.testing.assert_allclose(g8, g1, rtol=1e-5)
    dense = RefKernelOperator(kernel=_ref_kernel(), X=X, mode="dense")
    gMd = jax.grad(lambda m: jnp.sum(dense.matmul(m) ** 2))(M)
    np.testing.assert_allclose(out[f"grad_M_{backend}"], np.asarray(gMd), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def ref_mll(world):
    """The reference's single-device partitioned (xla) MLL and gradients."""
    inp, _ = world
    s = RefSettings(num_probes=2, max_cg_iters=25, precond_rank=0, panel_rows=64)
    gp = RefExactGP(mode="pallas_partitioned", panel_backend="xla", settings=s)
    X = jnp.asarray(inp["X512"])
    params = {k[2:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("p_")}
    loss, grads = jax.value_and_grad(gp.loss)(params, X, jnp.sin(X[:, 0]), jax.random.PRNGKey(2))
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_mll_grads_through_band_sharded_backward(world, ref_mll, backend):
    """ExactGP(mode="cuda_partitioned") under the ambient mesh of 8 ranks:
    the loss rtol 1e-4 and every gradient rtol 2e-3 / atol 1e-4 of one
    rank's, panel-fused 1e-3 and 5e-3 / 5e-4; one rank's against the
    reference's partitioned path (1e-4; 2e-3 / 1e-4)."""
    _, out = world
    pre = f"mll_{backend}_"
    np.testing.assert_allclose(out[pre + "8"], out[pre + "1"], rtol=1e-4)
    np.testing.assert_allclose(out[pre + "fused8"], out[pre + "1"], rtol=1e-3)
    np.testing.assert_allclose(out[pre + "1"], ref_mll[0], rtol=1e-4)
    for k, g in ref_mll[1].items():
        g1 = out[f"{pre}1_{k}"]
        np.testing.assert_allclose(out[f"{pre}8_{k}"], g1, rtol=2e-3, atol=1e-4, err_msg=k)
        np.testing.assert_allclose(out[f"{pre}fused8_{k}"], g1, rtol=5e-3, atol=5e-4, err_msg=k)
        np.testing.assert_allclose(g1, g, rtol=2e-3, atol=1e-4, err_msg=k)

"""The LM sharding rules of the port against the reference's, spec for spec.

The rules are pure functions of tree paths, shapes and the mesh's axis
sizes, so both packages evaluate them in-process with no devices: the
reference under ``jax.sharding.use_abstract_mesh(AbstractMesh(...))``, the
port under ``use_mesh(AbstractMesh(...))``.  For every arch of
``ALL_ARCHS`` at full size (the port's parameters made under
``FakeTensorMode``, the reference's by ``jax.eval_shape``) and reduced, and
for the meshes (2, 4), (16, 16) and (2, 16, 16) with "pod":
``params_shardings``, ``cache_shardings`` on ``init_cache`` shapes, and
``batch_shardings`` / ``input_specs`` on every cell of ``SHAPES``.  Then
``placements`` turns each spec into DTensor placements: axis a on
dimension i is ``Shard(i)`` on mesh dimension a.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.distributed import sharding as ref_sharding
from repro.models import batch_shardings as ref_batch_shardings
from repro.models import build_model as ref_build_model
from repro.models import input_specs as ref_input_specs
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.distributed import sharding as sh
from repro_torch.models import batch_shardings, build_model, input_specs
from repro_torch.tree import tree_flatten_with_paths

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_CELLS = [(4, 64), (128, 32768), (1, 524288)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch, size):
    if size == "full":
        return ref_get_config(arch), get_config(arch)
    return ref_get_config(arch).reduced(), get_config(arch).reduced()


_TREES = {}


def _trees(arch, size):
    """(reference bundle, its abstract params, port bundle, its fake
    params), once per (arch, size)."""
    if (arch, size) not in _TREES:
        rcfg, cfg = _cfgs(arch, size)
        rb, b = ref_build_model(rcfg), build_model(cfg)
        rparams = jax.eval_shape(lambda k: rb.init(k, max_seq=64),
                                 jax.ShapeDtypeStruct((2,), jnp.uint32))
        with FakeTensorMode():
            params = b.init(torch.Generator(), max_seq=64)
        _TREES[arch, size] = (rb, rparams, b, params)
    return _TREES[arch, size]


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p) for p, _ in flat], \
        [tuple(s) for _, s in flat]


def _port_specs(tree):
    paths, specs = tree_flatten_with_paths(tree)
    assert all(isinstance(s, sh.P) for s in specs)
    return paths, [tuple(s) for s in specs]


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_shardings_match_the_reference(arch, mesh, size):
    rb, rparams, b, params = _trees(arch, size)
    assert b.stacked_paths == rb.stacked_paths
    with jax.sharding.use_abstract_mesh(AbstractMesh(*mesh)):
        ref = _ref_specs(ref_sharding.params_shardings(rparams, rb.stacked_paths))
    with sh.use_mesh(sh.AbstractMesh(*mesh)):
        ours = _port_specs(sh.params_shardings(params, b.stacked_paths))
    assert ours[0] == ref[0]
    assert ours[1] == ref[1]
    # shapes too: the rules saw the same tensors
    assert [tuple(x.shape) for x in tree_flatten_with_paths(params)[1]] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(rparams)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_shardings_match_the_reference(arch, mesh):
    rb, _, b, params = _trees(arch, "full")
    for batch, length in CACHE_CELLS:
        rcache = jax.eval_shape(lambda: rb.init_cache(None, batch, length))
        with FakeTensorMode():
            cache = b.init_cache(params, batch, length)
        with jax.sharding.use_abstract_mesh(AbstractMesh(*mesh)):
            ref = _ref_specs(ref_sharding.cache_shardings(rcache))
        with sh.use_mesh(sh.AbstractMesh(*mesh)):
            ours = _port_specs(sh.cache_shardings(cache))
        assert ours == ref, (batch, length)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_shardings_and_input_specs_match_the_reference(arch, mesh):
    rcfg, cfg = _cfgs(arch, "full")
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        with jax.sharding.use_abstract_mesh(AbstractMesh(*mesh)):
            ref = {k: tuple(v) for k, v in ref_batch_shardings(rcfg, rshape).items()}
        with sh.use_mesh(sh.AbstractMesh(*mesh)):
            ours = {k: tuple(v) for k, v in batch_shardings(cfg, shape).items()}
        assert ours == ref, name
        rin, inp = ref_input_specs(rcfg, rshape), input_specs(cfg, shape)
        assert sorted(inp) == sorted(rin)
        for k in rin:
            assert tuple(inp[k].shape) == rin[k].shape and inp[k].is_meta, (name, k)
            want = {jnp.int32: torch.int64, jnp.bfloat16: torch.bfloat16,
                    jnp.float32: torch.float32}[rin[k].dtype.type]
            assert inp[k].dtype == want, (name, k)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_placements_put_each_axis_on_its_dimension(mesh):
    shape, axes = mesh
    with sh.use_mesh(sh.AbstractMesh(*mesh)):
        specs = []
        for arch in ALL_ARCHS:
            _, _, b, params = _trees(arch, "full")
            specs += tree_flatten_with_paths(sh.params_shardings(params, b.stacked_paths))[1]
            specs.append(sh.p_batch(None, "model"))
    for spec in specs:
        pl = sh.placements(spec, axes)
        assert len(pl) == len(axes)
        for a, p in zip(axes, pl):
            dims = [i for i, e in enumerate(spec)
                    if e == a or (isinstance(e, tuple) and a in e)]
            assert p == (Shard(dims[0]) if dims else Replicate()), (spec, a)
    # examples, and the data axes composing on one dimension
    assert sh.placements(sh.P("model", "data"), ("data", "model")) == (Shard(1), Shard(0))
    assert sh.placements(sh.P(None, "data", "model"), ("data", "model")) == (Shard(1), Shard(2))
    assert sh.placements(sh.P(("pod", "data"), None), ("pod", "data", "model")) == \
        (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements(sh.P(("data", "pod")), ("pod", "data", "model"))


def test_one_axis_tuples_normalise_as_the_reference():
    assert tuple(sh.P(("data",), None)) == tuple(JP(("data",), None)) == ("data", None)
    assert tuple(sh.P(("pod", "data"))) == tuple(JP(("pod", "data")))

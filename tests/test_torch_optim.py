"""The port's optimizers, schedules, clipping and int8 compression
(``repro_torch.optim``) against the reference's ``repro.optim`` on the
same trees: nested dicts of f32 and bf16 leaves (matrices, vectors,
scalars) with numpy values from a seed, three updates each, at rtol 1e-6
(bf16 leaves: the same bits, or one bf16 ulp where the f32 step straddles
a rounding boundary).  ``compressed_psum`` runs on a gloo world of two CPU
ranks against the reference's quantize / dequantize of each rank's
gradient, summed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro_torch import optim
from repro_torch.distributed import spawn_world
from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_unflatten


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


RTOL = 1e-6


def _tree(seed, bf16=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tree = {"w": f(6, 5), "layers": {"k": f(2, 4, 3), "b": f(7)}, "s": f()}
    if bf16:
        tree["layers"]["h"] = f(3, 8)  # held in bf16
    return tree


def _jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    if "h" in tree.get("layers", {}):
        out["layers"]["h"] = out["layers"]["h"].astype(jnp.bfloat16)
    return out


def _torch(tree):
    def leaf(path, x):
        t = torch.from_numpy(np.array(x))
        return t.to(torch.bfloat16) if path.endswith("/h") else t

    paths, leaves = tree_flatten_with_paths(tree)
    return tree_unflatten(tree, [leaf(p, x) for p, x in zip(paths, leaves)])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_trees_close(ours, ref, what):
    paths, leaves = tree_flatten_with_paths(ours)
    ref_leaves = jax.tree_util.tree_leaves(ref)
    assert len(leaves) == len(ref_leaves)
    for path, x, r in zip(paths, leaves, ref_leaves):
        if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
            ulp = np.abs(_np(r)) * 2.0**-7 + 1e-30
            assert np.all(np.abs(_np(x) - _np(r)) <= ulp), f"{what}: {path}"
        else:
            np.testing.assert_allclose(_np(x), _np(r), rtol=RTOL, atol=1e-7,
                                       err_msg=f"{what}: {path}")


SCHEDULES = {
    "constant": (lambda m: m.constant(0.01)),
    "cosine": (lambda m: m.cosine_decay(0.05, 4, floor=0.001)),
    "warmup_cosine": (lambda m: m.linear_warmup_cosine(0.05, 2, 6)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_the_reference(name):
    ours, ref = SCHEDULES[name](optim), SCHEDULES[name](ref_optim)
    for step in range(0, 9):
        s = float(step)
        np.testing.assert_allclose(float(ours(torch.tensor(s))), float(ref(jnp.float32(s))),
                                   rtol=RTOL)


OPTIMIZERS = {
    "adam": lambda m, lr: m.adam(lr),
    "adam_b": lambda m, lr: m.adam(lr, b1=0.8, b2=0.99, eps=1e-6),
    "adamw": lambda m, lr: m.adamw(lr, weight_decay=0.05),
    "adafactor": lambda m, lr: m.adafactor(lr),
    "adafactor_clip": lambda m, lr: m.adafactor(lr, clip_threshold=0.5),
}


@pytest.mark.parametrize("schedule", [None, "warmup_cosine"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_the_reference(name, schedule):
    """Three updates from the same params and gradients: the params (bf16
    leaves too), the state and its step."""
    lr_ours = 3e-2 if schedule is None else SCHEDULES[schedule](optim)
    lr_ref = 3e-2 if schedule is None else SCHEDULES[schedule](ref_optim)
    init, update = OPTIMIZERS[name](optim, lr_ours)
    rinit, rupdate = OPTIMIZERS[name](ref_optim, lr_ref)
    params, rparams = _torch(_tree(0)), _jax(_tree(0))
    state, rstate = init(params), rinit(rparams)
    _assert_trees_close(state, rstate, "init")
    for t in range(3):
        grads, rgrads = _torch(_tree(10 + t)), _jax(_tree(10 + t))
        params, state = update(grads, state, params)
        rparams, rstate = rupdate(rgrads, rstate, rparams)
        _assert_trees_close(params, rparams, f"{name} params, step {t}")
        _assert_trees_close(state, rstate, f"{name} state, step {t}")
    assert int(state.step) == 3 and state.step.dtype == torch.int32


def test_update_donates_params_and_moments():
    """The update writes into the caller's tensors (the reference's donated
    jitted step) and keeps every leaf's dtype."""
    params = _torch(_tree(0))
    init, update = optim.adam(1e-2)
    state = init(params)
    before = [p.data_ptr() for p in tree_leaves(params)] + [m.data_ptr() for m in tree_leaves(state.mu)]
    dtypes = [p.dtype for p in tree_leaves(params)]
    new, new_state = update(_torch(_tree(1)), state, params)
    assert [p.data_ptr() for p in tree_leaves(new)] + [m.data_ptr() for m in tree_leaves(new_state.mu)] == before
    assert [p.dtype for p in tree_leaves(new)] == dtypes
    assert all(m.dtype == torch.float32 for m in tree_leaves(new_state.nu))


def test_bf16_update_below_half_an_ulp_is_lost():
    """A bf16 parameter keeps its value when the f32 step is below half its
    ulp, in both packages (the reference's cast; ROADMAP Queue C)."""
    p = {"x": torch.full((4,), 256.0, dtype=torch.bfloat16)}  # ulp 2
    rp = {"x": jnp.full((4,), 256.0, jnp.bfloat16)}
    g = {"x": torch.ones(4)}
    init, update = optim.adam(0.5)
    rinit, rupdate = ref_optim.adam(0.5)
    p, _ = update(g, init(p), p)
    rp, _ = rupdate({"x": jnp.ones(4)}, rinit(rp), rp)
    assert float(p["x"][0]) == float(rp["x"][0]) == 256.0


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clipping_matches_the_reference(max_norm):
    tree, rtree = _torch(_tree(3)), _jax(_tree(3))
    np.testing.assert_allclose(float(optim.global_norm(tree)), float(ref_optim.global_norm(rtree)),
                               rtol=RTOL)
    clipped, norm = optim.clip_by_global_norm(tree, max_norm)
    rclipped, rnorm = ref_optim.clip_by_global_norm(rtree, max_norm)
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=RTOL)
    _assert_trees_close(clipped, rclipped, "clipped")
    assert [x.dtype for x in tree_leaves(clipped)] == [x.dtype for x in tree_leaves(tree)]
    if max_norm > float(norm):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(clipped), tree_leaves(tree)))


@pytest.mark.parametrize("shape", [(1000,), (3, 256), (7, 5, 3), (0,)])
def test_int8_compress_matches_the_reference(shape):
    x = (np.random.default_rng(1).standard_normal(shape) * 3).astype(np.float32)
    if x.size:
        x.reshape(-1)[:256] = 0.0  # an all-zero block: scale 1
    q, scale, shp = optim.int8_compress(torch.from_numpy(x))
    rq, rscale, rshp = ref_optim.int8_compress(jnp.asarray(x))
    assert shp == tuple(rshp) and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(rscale), rtol=RTOL)
    out = optim.int8_decompress(q, scale, shp)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_optim.int8_decompress(rq, rscale, rshp)),
                               rtol=RTOL)


def _psum_rank(rank, world, grads, errors):
    import torch

    from repro_torch import optim
    from repro_torch.distributed import make_mesh, use_mesh

    mesh = make_mesh((world,), ("data",))
    with use_mesh(mesh):
        out, err = optim.compressed_psum(torch.from_numpy(grads[rank]), "data",
                                         torch.from_numpy(errors[rank]))
    return out.numpy(), err.numpy()


def test_compressed_psum_on_two_ranks_matches_the_reference():
    """Each rank's error-corrected gradient quantized as the reference
    quantizes it; every rank holds the same sum (the reference's psum of
    the dequantized values) and its own residual."""
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal((5, 300)).astype(np.float32) for _ in range(2)]
    errors = [(0.01 * rng.standard_normal((5, 300))).astype(np.float32) for _ in range(2)]
    results = spawn_world(_psum_rank, 2, "gloo", args=(grads, errors), timeout=120.0)
    locals_ = []
    for r in range(2):
        corrected = jnp.asarray(grads[r]) + jnp.asarray(errors[r])
        q, s, shp = ref_optim.int8_compress(corrected)
        local = ref_optim.int8_decompress(q, s, shp)
        locals_.append(np.asarray(local))
        np.testing.assert_allclose(results[r][1], np.asarray(corrected - local), rtol=RTOL,
                                   atol=1e-7)
    np.testing.assert_array_equal(results[0][0], results[1][0])
    np.testing.assert_allclose(results[0][0], locals_[0] + locals_[1], rtol=RTOL, atol=1e-7)


def test_compressed_psum_without_a_mesh_is_a_world_of_one():
    g, e = torch.randn(40), torch.zeros(40)
    out, err = optim.compressed_psum(g, "data", e)
    q, s, shp = optim.int8_compress(g)
    torch.testing.assert_close(out, optim.int8_decompress(q, s, shp), rtol=0, atol=0)
    torch.testing.assert_close(err, g - out, rtol=0, atol=0)

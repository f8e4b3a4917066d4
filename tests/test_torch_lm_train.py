"""LM training in the port against the reference, for every architecture of
``ALL_ARCHS`` on its reduced config in f32: ``bundle.loss`` and the
gradient of every leaf against ``jax.value_and_grad`` of the reference's
loss (rtol 1e-4 / atol 1e-6), then three ``make_train_step`` steps against
the reference's (loss, gradient norm and every parameter and moment).

Parameters are the reference's own init carried over by
``lm_params_from_jax``; batches are numpy tokens (and whisper's frames)
from a seed, fed to both packages.  The MoE models (granite, deepseek)
hold the aux term in the loss, and the test checks that the port's routing
of every MoE call is the reference's (top-k experts and each expert's
top-C tokens, recorded from ``jax.lax.top_k`` through
``jax.debug.callback``): routing is discontinuous (ROADMAP Queue C item
22), so a loss compared where it disagreed would prove nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import make_train_step as ref_make_train_step
from repro_torch import lm_params_from_jax
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.models import build_model, loss_and_grads, make_train_step, moe
from repro_torch.optim import AdamState
from repro_torch.tree import tree_flatten_with_paths, tree_leaves, tree_unflatten


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 12
LR = 3e-3  # the train CLI's
MOE_ARCHS = ("granite-moe-1b-a400m", "deepseek-v2-236b")


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    out = {"tokens": torch.from_numpy(batch["tokens"].astype(np.int64))}
    if "frames" in batch:
        out["frames"] = torch.from_numpy(batch["frames"])
    return out


def _ref_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]



@pytest.fixture(scope="module", params=ALL_ARCHS)
def case(request):
    """The reference's side, once per arch: its init, and one jitted call a
    step that returns ``jax.value_and_grad`` of the loss and the
    reference's ``make_train_step`` result on the same batch, with the
    state each step started from."""
    arch = request.param
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    rbundle, bundle = ref_build_model(rcfg), build_model(cfg)
    rparams = rbundle.init(jax.random.PRNGKey(5), max_seq=S + 8)
    rstep, rinit = ref_make_train_step(rbundle, lr=LR)

    @jax.jit
    def both(p, o, b):
        return jax.value_and_grad(lambda q: rbundle.loss(q, b, True))(p), rstep(p, o, b)

    batches = [_batch(cfg, 10 + t) for t in range(3)]
    rp, ropt, steps = rparams, rinit(rparams), []
    for b in batches:
        (loss, grads), (np_, nopt, m) = both(rp, ropt, _jax_batch(b))
        steps.append({"loss": float(loss), "grads": grads, "metrics": m, "start": (rp, ropt),
                      "end": (np_, nopt)})
        rp, ropt = np_, nopt
    return dict(arch=arch, rcfg=rcfg, cfg=cfg, bundle=bundle, rparams=rparams, batches=batches,
                steps=steps)


def _reference_routing(rcfg, rparams, tokens):
    """Every ``jax.lax.top_k`` result of the reference's forward, in call
    order (per MoE layer: the top-k experts, then each expert's top-C
    tokens)."""
    from repro.models import transformer as ref_transformer

    calls = []
    real = jax.lax.top_k

    def top_k(x, k):
        vals, idx = real(x, k)
        jax.debug.callback(lambda v, i: calls.append((np.asarray(v), np.asarray(i))), vals, idx,
                           ordered=True)
        return vals, idx

    jax.lax.top_k = top_k
    try:
        jax.jit(lambda p, t: ref_transformer.forward(p, rcfg, t)[1])(rparams, jnp.asarray(tokens))
        jax.effects_barrier()
    finally:
        jax.lax.top_k = real
    return calls


def test_loss_and_every_gradient_match_the_reference(case, monkeypatch):
    arch, cfg, bundle = case["arch"], case["cfg"], case["bundle"]
    batch, ref = case["batches"][0], case["steps"][0]
    params = lm_params_from_jax(case["rparams"], device="cpu")
    routings = []
    if arch in MOE_ARCHS:
        real = moe.moe_route
        monkeypatch.setattr(moe, "moe_route", lambda *a, **kw: routings.append(real(*a, **kw))
                            or routings[-1])
    loss, grads = loss_and_grads(bundle, params, _torch_batch(batch))

    if arch in MOE_ARCHS:  # the routing is the reference's, call by call
        ref_calls = _reference_routing(case["rcfg"], case["rparams"], batch["tokens"][:, :-1])
        # the backward's recompute (the layers' remat) routes every MoE
        # layer again, the last first: on the forward's bits
        n = len(ref_calls) // 2
        assert routings and len(routings) == 2 * n
        for r, again in zip(routings[:n], reversed(routings[n:])):
            for a, b in zip(r, again):
                assert torch.equal(a, b)
        for i, r in enumerate(routings[:n]):
            (_, ref_topk), (ref_sel_val, ref_sel) = ref_calls[2 * i], ref_calls[2 * i + 1]
            np.testing.assert_array_equal(r.topk_idx.numpy(), ref_topk)
            live = ref_sel_val > 0
            np.testing.assert_array_equal(r.sel_val.detach().numpy() > 0, live)
            np.testing.assert_array_equal(r.sel_idx.numpy()[live], ref_sel[live])

    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    paths, ours = tree_flatten_with_paths(grads)
    ref_grads = _ref_leaves(ref["grads"])
    assert len(ours) == len(ref_grads)
    witness = None
    for path, g, r in zip(paths, ours, ref_grads):
        assert g is not None, f"{arch}: {path} has no gradient"
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, path
        g = g.numpy()
        if np.allclose(g, r, **GRAD_TOL):
            continue
        # where the reference's own f32 rounding exceeds the tolerance (the
        # hybrid's deep SSD chains), hold both to the port in f64: the port
        # no further from it than twice the reference, and within 1e-4 of
        # the leaf's scale of the reference
        if witness is None:
            p64 = tree_unflatten(params, [x.double() for x in tree_leaves(params)])
            b64 = {k: v.double() if v.is_floating_point() else v
                   for k, v in _torch_batch(batch).items()}
            witness = dict(zip(*tree_flatten_with_paths(loss_and_grads(bundle, p64, b64)[1])))
        w = witness[path].numpy()
        ours_err, ref_err = np.abs(g - w).max(), np.abs(r - w).max()
        scale = np.abs(w).max()
        assert ours_err <= 2 * ref_err + GRAD_TOL["atol"], (arch, path, ours_err, ref_err)
        assert np.abs(g - r).max() <= GRAD_TOL["rtol"] * scale, (arch, path, scale)


def test_moe_loss_carries_the_aux_term(case):
    """The loss is CE + 0.01 × the Switch loss: dropping the aux weight
    moves the port's loss by 0.01 × the reference's aux (a dense model's
    aux is 0)."""
    from repro.models import transformer as ref_transformer
    from repro_torch.models import transformer

    cfg = case["cfg"]
    if cfg.family not in ("dense", "moe"):
        pytest.skip("no aux term outside the transformer")
    batch = case["batches"][1]
    params = lm_params_from_jax(case["rparams"], device="cpu")
    tb = _torch_batch(batch)
    full = transformer.loss_fn(params, cfg, tb)
    ce = transformer.loss_fn(params, cfg, tb, aux_weight=0.0)
    _, raux = ref_transformer.forward(case["rparams"], case["rcfg"],
                                      jnp.asarray(batch["tokens"][:, :-1]), use_scan=True)
    assert (float(raux) > 0) == (case["arch"] in MOE_ARCHS)
    np.testing.assert_allclose(float(full - ce), 0.01 * float(raux), rtol=1e-4, atol=1e-7)


def _port_state(rparams, ropt):
    params = lm_params_from_jax(rparams, device="cpu")
    opt = AdamState(torch.tensor(int(ropt.step), dtype=torch.int32),
                    lm_params_from_jax(ropt.mu, device="cpu"),
                    lm_params_from_jax(ropt.nu, device="cpu"))
    return params, opt


def test_three_train_steps_match_the_reference(case):
    """Three steps of ``make_train_step`` (lr 3e-3, clip 1.0, Adam), each
    from the reference's state before it, against the reference's step:
    the loss, the gradient norm, both moments and every parameter.

    Adam's step is scale-free: it moves a parameter by up to lr whatever the
    size of its gradient, in the direction of the first moment.  Where that
    moment is at the level of f32 rounding — below 1e-3 of its leaf's
    largest, or below 1e-6 of the largest of all, as in the key biases
    (``bk``), whose gradient is exactly zero (softmax is invariant to one
    shift of every key's logit) — either
    package's rounding sets the direction, so such entries are held only to
    Adam's bound, |Δp| ≤ 2·lr, and every other entry to rtol 1e-4 / atol
    1e-5.  A chain of steps from one start would compound exactly these
    flips (the reduced zamba2's loss parts by 9e-5 at the second step)."""
    arch, bundle = case["arch"], case["bundle"]
    step, _ = make_train_step(bundle, lr=LR)
    for t, (batch, ref) in enumerate(zip(case["batches"], case["steps"])):
        params, opt = _port_state(*ref["start"])
        params, opt, m = step(params, opt, _torch_batch(batch))
        rm = ref["metrics"]
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
        rp, ropt = ref["end"]
        assert int(opt.step) == int(ropt.step) == t + 1
        mu_ref = dict(zip(tree_flatten_with_paths(opt.mu)[0], _ref_leaves(ropt.mu)))
        mu_floor = 1e-6 * max(np.abs(m).max() for m in mu_ref.values())
        for name, ours, theirs in (("mu", opt.mu, ropt.mu), ("nu", opt.nu, ropt.nu)):
            ref_leaves = _ref_leaves(theirs)
            # 1e-6 of the tree's largest moment: the rounding noise of a
            # zero gradient (bk), as GRAD_TOL's atol is the gradients'
            floor = 1e-6 * max(np.abs(r).max() for r in ref_leaves)
            for path, x, r in zip(*tree_flatten_with_paths(ours), ref_leaves):
                err = np.abs(x.numpy() - r).max()
                assert err <= 1e-4 * np.abs(r).max() + floor, (arch, t, name, path)
        for path, x, r in zip(*tree_flatten_with_paths(params), _ref_leaves(rp)):
            mu = np.abs(mu_ref[path])
            firm = mu >= max(1e-3 * mu.max(), mu_floor)
            diff = np.abs(x.detach().numpy() - r)
            assert diff.max() <= 2 * LR + 1e-5, (arch, t, path)
            np.testing.assert_allclose(x.detach().numpy()[firm], r[firm], **STEP_TOL,
                                       err_msg=f"{arch} step {t}: {path}")


def test_params_leaf_order_is_the_references(case):
    """The port flattens a param tree in ``jax.tree_util``'s order (sorted
    keys): the contract of the clip's sum and of the checkpoint."""
    rparams = case["rparams"]
    params = lm_params_from_jax(rparams, device="cpu")
    ref_paths = ["/".join(str(k.key) for k in p)
                 for p, _ in jax.tree_util.tree_flatten_with_path(rparams)[0]]
    assert tree_flatten_with_paths(params)[0] == ref_paths
    assert [tuple(x.shape) for x in tree_leaves(params)] == [x.shape for x in _ref_leaves(rparams)]

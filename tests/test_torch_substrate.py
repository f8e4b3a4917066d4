"""The port's training substrate against the reference's
(tests/test_substrate.py's checks, plus the two packages' checkpoints
crossing over):

* ``TokenStream``: determinism by (seed, step, shard), shard shapes, the
  token range, and the reference's statistics (the bigram share and the
  Zipf-like head) within a few points — the bits cannot match: the
  reference draws from ``jax.random`` (ROADMAP Queue C);
* the checkpointer: round trip and GC, async, an incomplete checkpoint
  ignored, bf16 / int32 leaves and the structure, the reference's on-disk
  layout; a reference-written checkpoint of a reduced llama3.2-1b after two
  train steps restores in the port, which trains on two steps to the
  reference's four-step state, and the other way round;
* the fault layer: the preemption flag, the watchdog, both
  ``restart_loop`` outcomes.
"""

import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.data.pipeline import TokenStream as RefTokenStream
from repro.models import build_model as ref_build_model
from repro.models import make_train_step as ref_make_train_step
from repro_torch import lm_params_from_jax
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.distributed import PreemptionHandler, StragglerWatchdog, restart_loop
from repro_torch.models import build_model, make_train_step
from repro_torch.optim import AdamState
from repro_torch.tree import tree_flatten_with_paths, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- TokenStream ----------------------------------------------------------------


def test_token_stream_is_deterministic_by_step():
    s1, s2 = TokenStream(1000, 8, 32, seed=7), TokenStream(1000, 8, 32, seed=7)
    np.testing.assert_array_equal(s1.batch_at(13)["tokens"], s2.batch_at(13)["tokens"])
    assert not np.array_equal(s1.batch_at(13)["tokens"], s1.batch_at(14)["tokens"])
    assert not np.array_equal(s1.batch_at(13)["tokens"],
                              TokenStream(1000, 8, 32, seed=8).batch_at(13)["tokens"])
    first = next(iter(s1))["tokens"]
    np.testing.assert_array_equal(first, s1.batch_at(0)["tokens"])


def test_token_stream_shards():
    shards = [TokenStream(1000, 8, 32, seed=0, num_shards=4, shard=i) for i in range(4)]
    batches = [s.batch_at(3)["tokens"] for s in shards]
    assert all(b.shape == (2, 33) and b.dtype == np.int32 for b in batches)
    assert len({b.tobytes() for b in batches}) == 4  # each shard its own draw


def _bigram_share(tokens, vocab):
    return float(np.mean(tokens[:, 1:] == (tokens[:, :-1] * 2 + 1) % vocab))


@pytest.mark.parametrize("vocab", [512, 50_000])
def test_token_stream_statistics_are_the_references(vocab):
    """Tokens in [0, vocab); the share of 2i → 2i + 1 bigrams and of the
    head (token 0) as in the reference's stream, over 64 × 257 tokens."""
    ours = np.concatenate([TokenStream(vocab, 16, 256, seed=s).batch_at(0)["tokens"]
                           for s in range(4)])
    ref = np.concatenate([np.asarray(RefTokenStream(vocab, 16, 256, seed=s).batch_at(0)["tokens"])
                          for s in range(4)])
    assert ours.min() >= 0 and ours.max() < vocab
    assert abs(_bigram_share(ours, vocab) - _bigram_share(ref, vocab)) < 0.03
    assert _bigram_share(ours, vocab) > 0.2
    assert abs(np.mean(ours == 0) - np.mean(ref == 0)) < 0.02


# -- the checkpointer -------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"w": torch.arange(12.0).reshape(3, 4), "nested": {"b": torch.ones(5)}}
    ck = Checkpointer(str(tmp_path), keep=2)
    for step in [10, 20, 30, 40]:
        ck.save(step, {"w": tree["w"] * step, "nested": {"b": tree["nested"]["b"] * step}})
    assert ck.all_steps() == [30, 40]  # GC keeps the last 2
    assert sorted(os.listdir(tmp_path)) == ["step_30", "step_30.COMMIT", "step_40", "step_40.COMMIT"]
    step, restored = ck.restore_latest(tree)
    assert step == 40
    torch.testing.assert_close(restored["w"], tree["w"] * 40, rtol=0, atol=0)


def test_checkpoint_async_snapshots_before_returning(tmp_path):
    """save_async copies the leaves before it returns: an in-place update
    right after does not reach the checkpoint."""
    w = torch.ones((100, 100))
    ck = Checkpointer(str(tmp_path))
    ck.save_async(5, {"w": w})
    w.mul_(3.0)
    ck.wait()
    assert ck.latest_step() == 5
    assert float(ck.restore(5, {"w": w})["w"].max()) == 1.0


def test_incomplete_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(3)})
    os.makedirs(tmp_path / "step_2")  # a crash mid-write: no COMMIT marker
    os.makedirs(tmp_path / ".tmp_step_3")
    assert ck.latest_step() == 1


def test_checkpoint_dtypes_structure_and_layout(tmp_path):
    """bf16 stored as its u2 bits with "bfloat16" in the index (the
    reference's layout), int32 and the NamedTuple state in leaf order; a
    structure with another leaf count or shape is refused."""
    tree = {"b": {"z": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)},
            "a": torch.zeros((2, 2), dtype=torch.int32),
            "opt": AdamState(torch.tensor(7, dtype=torch.int32), {"x": torch.ones(2)},
                             {"x": torch.full((2,), 2.0)})}
    ck = Checkpointer(str(tmp_path))
    ck.save(0, tree)
    with open(tmp_path / "step_0" / "index.json") as f:
        index = json.load(f)
    assert index["paths"] == ["a", "b/z", "opt/.step", "opt/.mu/x", "opt/.nu/x"]
    assert [m["dtype"] for m in index["leaves"]] == ["int32", "bfloat16", "int32", "float32",
                                                      "float32"]
    assert np.load(tmp_path / "step_0" / "leaf_1.npy").dtype == np.uint16
    out = ck.restore(0, tree)
    assert out["b"]["z"].dtype == torch.bfloat16 and out["a"].dtype == torch.int32
    assert torch.equal(out["b"]["z"], tree["b"]["z"]) and int(out["opt"].step) == 7
    assert isinstance(out["opt"], AdamState)
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore(0, {"a": tree["a"]})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(0, dict(tree, a=torch.zeros((3, 2), dtype=torch.int32)))


LR = 3e-3
B, S = 2, 12


def _llama():
    rcfg, cfg = ref_get_config("llama3.2-1b").reduced(), get_config("llama3.2-1b").reduced()
    rbundle = ref_build_model(rcfg)
    return rcfg, cfg, rbundle, build_model(cfg), rbundle.init(jax.random.PRNGKey(3))


def _tokens(vocab, step):
    return np.random.default_rng(100 + step).integers(0, vocab, (B, S + 1)).astype(np.int32)


def _assert_state_close(port_params, port_opt, ref_params, ref_opt, steps):
    """Every moment within 1e-4 of its leaf's scale; every parameter within
    Adam's bound of 2·lr a step, and all but 1e-3 of each leaf's entries at
    rtol 1e-4 / atol 1e-5.  Adam's step is scale-free: an entry whose
    first moment is at the level of f32 rounding moves by up to lr in a
    direction either package's rounding sets (tests/test_torch_lm_train.py),
    and a chain of steps carries such a flip on."""
    assert int(port_opt.step) == int(ref_opt.step)
    for ours, ref in ((port_opt.mu, ref_opt.mu), (port_opt.nu, ref_opt.nu)):
        for path, x, r in zip(*tree_flatten_with_paths(ours), jax.tree_util.tree_leaves(ref)):
            r = np.asarray(r)
            assert np.abs(x.numpy() - r).max() <= 1e-4 * np.abs(r).max() + 1e-12, path
    for (path, x), r in zip(zip(*tree_flatten_with_paths(port_params)),
                            jax.tree_util.tree_leaves(ref_params)):
        r, x = np.asarray(r), x.numpy()
        assert np.abs(x - r).max() <= 2 * LR * steps, path
        assert np.mean(~np.isclose(x, r, rtol=1e-4, atol=1e-5)) <= 1e-3, path


@pytest.fixture(scope="module")
def reference_run():
    """The reference's four train steps of the reduced llama, with its state
    after two."""
    rcfg, cfg, rbundle, bundle, rparams = _llama()
    rstep, rinit = ref_make_train_step(rbundle, lr=LR)
    rstep = jax.jit(rstep)
    rp, ropt, states = rparams, rinit(rparams), []
    for step in range(4):
        rp, ropt, _ = rstep(rp, ropt, {"tokens": jnp.asarray(_tokens(cfg.vocab_size, step))})
        states.append((rp, ropt))
    return cfg, bundle, rparams, rinit, rstep, states


def test_reference_checkpoint_trains_on_in_the_port(reference_run, tmp_path):
    cfg, bundle, rparams, rinit, rstep, states = reference_run
    RefCheckpointer(str(tmp_path)).save(1, {"params": states[1][0], "opt": states[1][1]})
    step_fn, init = make_train_step(bundle, lr=LR)
    like_params = lm_params_from_jax(rparams, device="cpu")
    like = {"params": like_params, "opt": init(like_params)}
    step, state = Checkpointer(str(tmp_path)).restore_latest(like)
    assert step == 1 and int(state["opt"].step) == 2
    params, opt = state["params"], state["opt"]
    for t in (2, 3):
        batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab_size, t).astype(np.int64))}
        params, opt, _ = step_fn(params, opt, batch)
    _assert_state_close(params, opt, *states[3], steps=2)


def test_port_checkpoint_trains_on_in_the_reference(reference_run, tmp_path):
    """The port's state after two steps, written by the port, restores in
    the reference with the same bits, and the reference's two further steps
    from it end where the port's own two further steps end."""
    cfg, bundle, rparams, rinit, rstep, states = reference_run
    step_fn, init = make_train_step(bundle, lr=LR)
    params = lm_params_from_jax(rparams, device="cpu")
    opt = init(params)
    batches = [torch.from_numpy(_tokens(cfg.vocab_size, t).astype(np.int64)) for t in range(4)]
    for t in (0, 1):
        params, opt, _ = step_fn(params, opt, {"tokens": batches[t]})
    _assert_state_close(params, opt, *states[1], steps=2)
    Checkpointer(str(tmp_path)).save(1, {"params": params, "opt": opt})
    like = {"params": rparams, "opt": rinit(rparams)}
    step, state = RefCheckpointer(str(tmp_path)).restore_latest(like)
    assert step == 1
    for ours, theirs in zip(tree_leaves({"params": params, "opt": opt}),
                            jax.tree_util.tree_leaves(state)):
        assert ours.dtype == torch.float32 or ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    rp, ropt = state["params"], state["opt"]
    for t in (2, 3):
        rp, ropt, _ = rstep(rp, ropt, {"tokens": jnp.asarray(_tokens(cfg.vocab_size, t))})
        params, opt, _ = step_fn(params, opt, {"tokens": batches[t]})
    _assert_state_close(params, opt, rp, ropt, steps=2)


def test_bf16_params_cross_over_bit_for_bit(tmp_path):
    """A bf16 tree written by the reference reads back in the port with the
    same bits, and the port's reads back in the reference."""
    x = np.random.default_rng(0).standard_normal((4, 6)).astype(np.float32)
    rtree = {"w": jnp.asarray(x, jnp.bfloat16), "s": jnp.int32(3)}
    RefCheckpointer(str(tmp_path / "r")).save(0, rtree)
    like = {"w": torch.zeros((4, 6), dtype=torch.bfloat16), "s": torch.tensor(0, dtype=torch.int32)}
    out = Checkpointer(str(tmp_path / "r")).restore(0, like)
    bits = np.asarray(rtree["w"]).view(np.uint16)
    np.testing.assert_array_equal(out["w"].view(torch.int16).numpy().view(np.uint16), bits)
    Checkpointer(str(tmp_path / "p")).save(0, out)
    back = RefCheckpointer(str(tmp_path / "p")).restore(0, rtree)
    assert back["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["w"]).view(np.uint16), bits)
    assert int(back["s"]) == 3 and tree_leaves(out)[0].dtype == torch.int32


# -- the fault layer --------------------------------------------------------------


def test_tree_walks_leave_no_reference_cycle():
    """Flattening and rebuilding a tree frees its leaves as soon as the
    caller drops them, without the garbage collector: the models walk
    each layer's parameters in every forward (``params_for_use``), and a
    cycle there kept a whole f32 stack alive on the card through an f64
    conversion of an 81-layer model."""
    import gc
    import weakref

    from repro_torch.tree import tree_unflatten

    was = gc.isenabled()
    gc.disable()
    try:
        t = torch.zeros(4)
        ref = weakref.ref(t)
        tree = {"b": [t, (1.0, None)], "a": {"c": t}}
        rebuilt = tree_unflatten(tree, tree_leaves(tree))
        assert rebuilt["b"][0] is t and list(rebuilt) == ["b", "a"]
        del t, tree, rebuilt
        assert ref() is None
    finally:
        if was:
            gc.enable()


def test_preemption_flag():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionHandler() as h:
        assert not h.requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.requested
    assert signal.getsignal(signal.SIGTERM) == before


def test_watchdog_flags_stragglers():
    w = StragglerWatchdog(threshold=5.0)
    for i in range(10):
        w.step_start()
        time.sleep(0.002)
        w.step_end(i)
    w.step_start()
    time.sleep(0.05)  # 25× the median
    w.step_end(99)
    assert w.straggler_count == 1 and w.events[0]["step"] == 99


def test_restart_loop_recovers():
    attempts, restarts = [], []

    def run(attempt):
        attempts.append(attempt)
        if attempt < 2:
            raise RuntimeError("boom")
        return 42

    assert restart_loop(run, max_restarts=3, on_restart=lambda n, e: restarts.append(n)) == 42
    assert attempts == [0, 1, 2] and restarts == [1, 2]


def test_restart_loop_gives_up():
    with pytest.raises(RuntimeError, match="x"):
        restart_loop(lambda a: (_ for _ in ()).throw(RuntimeError("x")), max_restarts=1)

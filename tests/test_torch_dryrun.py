"""The dry-run, roofline and report tools of the port against the
reference's.

  * ``active_param_count``, ``model_flops_estimate`` and ``extrapolate``
    equal the reference's for every arch × shape cell;
  * ``report``'s tables are the reference's strings on the same artifact
    rows;
  * a reduced llama train cell runs on a fake (2, 4) process group (the
    module's fixture creates each fake world and destroys it): status ok,
    per-device bytes above 0 and at most the (1, 1) cell's, and the
    (1, 1) cell's FLOPs equal to an analytic count of its matmuls;
  * the CLI writes an artifact that the report renders.
"""

import json

import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import report as ref_report
from repro.launch import roofline as ref_roofline
from repro_torch.configs import ALL_ARCHS, SHAPES, ShapeConfig, get_config
from repro_torch.launch import dryrun, report, roofline
from repro_torch.models import layers

CELL = ShapeConfig("train_small", 32, 8, "train")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_roofline_formulas_are_the_references(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert roofline.active_param_count(cfg) == ref_roofline.active_param_count(rcfg)
    for name, shape in SHAPES.items():
        assert roofline.model_flops_estimate(cfg, shape) == \
            ref_roofline.model_flops_estimate(rcfg, REF_SHAPES[name])
    for f1, f2, L in ((1.0, 3.5, 16), (2e12, 1.9e12, 80), (0.0, 7.0, 1)):
        assert roofline.extrapolate(f1, f2, L) == ref_roofline.extrapolate(f1, f2, L)


def _cfg():
    return get_config("llama3.2-1b").reduced(num_heads=4, num_kv_heads=2, vocab_size=512)


@pytest.fixture(scope="module")
def cells():
    out = {}
    for mesh_shape in ((1, 1), (2, 4)):
        world = mesh_shape[0] * mesh_shape[1]
        with dryrun.fake_world(world):
            out[mesh_shape] = dryrun.analyze_cell("llama3.2-1b", CELL.name, cfg=_cfg(), shape=CELL,
                                                  mesh_shape=mesh_shape)
        assert not torch.distributed.is_initialized()
    return out


def _matmul_flops(cfg, shape):
    """The forward's matmuls (projections, the two attention products, the
    SwiGLU MLP, the tied unembedding), times 3: the backward computes the
    gradient of both operands of each; and the layers' once more, but for
    the MLP's out-projection: the backward recomputes every
    rematerialised block's forward up to the last value it saved (the
    out-projection's input; its output feeds only the residual add, whose
    backward needs nothing saved), where torch's checkpoint stops."""
    B, S = shape.global_batch, shape.seq_len
    T, d, H, KV, hd, f = B * S, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim, cfg.d_ff
    layer = 2 * T * d * (H + 2 * KV) * hd + 2 * T * H * hd * d  # q, k, v, o
    layer += 2 * (2 * B * H * S * S * hd)  # q·kᵀ and p·v
    layer += 3 * 2 * T * d * f  # gate, in, out
    head = 2 * T * d * cfg.padded_vocab
    assert cfg.tie_embeddings
    recompute = layer - 2 * T * f * d
    return 3 * (cfg.num_layers * layer + head) + cfg.num_layers * recompute


def test_reduced_llama_cell_on_a_fake_mesh(cells):
    one, mesh = cells[(1, 1)], cells[(2, 4)]
    for cell in (one, mesh):
        assert cell["analysis"]["flops"] > 0 and cell["per_device_bytes"] > 0
    assert mesh["mesh"] == "2x4" and one["mesh"] == "1x1"
    assert mesh["per_device_bytes"] <= one["per_device_bytes"]
    assert mesh["raw_collectives"]["total"] > 0 and one["raw_collectives"]["total"] == 0
    assert one["raw_flops"] == _matmul_flops(_cfg(), CELL)
    assert mesh["raw_flops"] < one["raw_flops"]


def test_remat_lowers_the_peak(cells, monkeypatch):
    """The (1, 1) cell again with ``layers.remat`` patched out: the
    activations the rematerialised blocks no longer keep show in the peak
    of live storage, and the recompute in the FLOPs."""
    monkeypatch.setattr(layers, "remat", lambda fn, *args: fn(*args))
    with dryrun.fake_world(1):
        kept = dryrun.analyze_cell("llama3.2-1b", CELL.name, cfg=_cfg(), shape=CELL,
                                   mesh_shape=(1, 1))
    remat = cells[(1, 1)]
    assert remat["per_device_bytes"] < kept["per_device_bytes"]
    assert remat["raw_flops"] > kept["raw_flops"]


# One reduced cell for each kind of failure the full sweep had (each fails
# on the port before its repair): the config cut to size where the kind
# still shows — the same divisibility of heads, KV heads and head_dim by
# the model axis as the full config on 16.
KIND_CELLS = {
    # the greedy token's argmax over vocab shards read a value on the host
    "argmax_decode": ("llama3.2-1b", dict(num_heads=8, num_kv_heads=2),
                      ShapeConfig("decode_32k", 64, 8, "decode"), (2, 4)),
    # a branch's pending sum was reduce-scattered onto the sequence, which
    # the MLP's product over the flattened (batch, sequence) cannot take
    "sequence_over_model": ("llama3.2-1b", dict(num_heads=8, num_kv_heads=2),
                            ShapeConfig("prefill_32k", 32, 4, "prefill"), (2, 4)),
    # an einsum folded the sharded batch and heads into one strided dimension
    "strided_bmm": ("deepseek-v2-236b", dict(num_heads=8, num_kv_heads=8),
                    ShapeConfig("train_4k", 16, 4, "train"), (2, 4)),
    "strided_bmm_ssd": ("mamba2-370m", {}, ShapeConfig("train_4k", 16, 4, "train"), (2, 4)),
    # MLA's 10 heads over a model axis of 4 (minicpm3's 40 over 16)
    "mla_uneven_heads": ("minicpm3-4b", dict(num_heads=10, num_kv_heads=10),
                         ShapeConfig("train_4k", 16, 4, "train"), (2, 4)),
    # the causal conv padded a pending sum
    "pad_partial": ("mamba2-370m", {}, ShapeConfig("prefill_32k", 32, 4, "prefill"), (2, 4)),
    # decode at batch 1 over a cache whose sequence lies over "data"
    "sequence_sharded_cache": ("zamba2-7b", dict(num_heads=8, num_kv_heads=8),
                               ShapeConfig("long_500k", 64, 1, "decode"), (2, 4)),
    # the unembedding's weight gradient over a (pod, data) batch
    "pod_train": ("llama3.2-1b", dict(num_heads=8, num_kv_heads=2),
                  ShapeConfig("train_4k", 16, 4, "train"), (2, 2, 2)),
}


@pytest.mark.parametrize("kind", list(KIND_CELLS))
def test_failure_kind_runs_on_a_fake_mesh(kind):
    arch, red, shape, mesh_shape = KIND_CELLS[kind]
    cfg = get_config(arch).reduced(**red, vocab_size=512)
    world = 1
    for n in mesh_shape:
        world *= n
    with dryrun.fake_world(world):
        cell = dryrun.analyze_cell(arch, shape.name, cfg=cfg, shape=shape, mesh_shape=mesh_shape)
    assert cell["per_device_bytes"] > 0 and cell["raw_flops"] > 0


def test_a_failing_cell_keeps_the_ports_frames(monkeypatch, tmp_path):
    """The artifact of a cell that raises names the port's innermost lines,
    however long the error: the traceback's tail alone would hold only the
    message."""
    def body():
        raise RuntimeError("propagation failed " * 400)

    monkeypatch.setattr(dryrun, "analyze_cell", lambda *a, **k: layers.remat(lambda x: body(), None))
    result = dryrun.run_one("llama3.2-1b", "train_4k", False, str(tmp_path))
    assert result["status"] == "error"
    assert "models/layers.py" not in result["traceback"]
    assert any("models/layers.py" in f and "remat" in f for f in result["port_frames"])
    saved = json.loads((tmp_path / "llama3.2-1b_train_4k_16x16.json").read_text())
    assert saved["port_frames"] == result["port_frames"]


def test_report_tables_are_the_references(cells, tmp_path):
    rows = [dict(cells[k], status="ok") for k in ((1, 1), (2, 4))]
    rows.append({"arch": "qwen1.5-110b", "shape": "train_4k", "mesh": "16x16",
                 "status": "error", "error": "RuntimeError: out of memory " * 10})
    for mesh in ("1x1", "2x4", "16x16"):
        assert report.roofline_table(rows, mesh) == ref_report.roofline_table(rows, mesh)
    assert report.dryrun_table(rows) == ref_report.dryrun_table(rows)
    assert report.summarize(rows) == ref_report.summarize(rows)
    for i, r in enumerate(rows):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert report.load(str(tmp_path)) == ref_report.load(str(tmp_path))


def test_gp_cell_is_analytic():
    cell = dryrun.gp_cell("gp-exact-2m")
    assert cell["method"] == "analytic" and cell["mesh"] == "16x16"
    a = cell["analysis"]
    assert a["peak_flops"] == roofline.PEAK_FLOPS_F32 and a["bottleneck"] in (
        "compute", "memory", "collective")

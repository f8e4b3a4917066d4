"""Every architecture of the reference's zoo serves on the CPU through the
port's entry points (mirrors tests/test_models_smoke.py:63-75): the
reduced config builds with ``build_model``, prefills with
``make_prefill_step``, serves three greedy tokens with ``make_serve_step``
and runs ``launch.serve.main --device cpu`` (tied-embedding models
included); no B4 / B5 launch counter moves on the CPU.
"""

import pytest
import torch

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro_torch.configs import ALL_ARCHS, get_config, list_configs
from repro_torch.kernels.flash_attention import flash_attention as fa_mod
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
from repro_torch.launch import serve
from repro_torch.models import build_model, make_prefill_step, make_serve_step


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small torch ops run fastest on one thread, and spin on
    eight under a parallel test run (six workers on eight cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_every_reference_arch_is_registered():
    assert ALL_ARCHS == REF_ARCHS
    assert list_configs() == sorted(ALL_ARCHS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_and_three_greedy_tokens(arch):
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(4), max_seq=64)
    B, S, cache_len = 2, 8, 32
    batch = serve.make_batch(cfg, B, S, seed=4, device="cpu")
    assert ("frames" in batch) == (cfg.family == "encdec")
    before = (fa_mod.launches, ssd_mod.launches)
    tok, cache = make_prefill_step(bundle, cache_len)(params, batch)
    assert tok.shape == (B,) and bool(((tok >= 0) & (tok < cfg.padded_vocab)).all())
    if cfg.family in ("ssm", "hybrid"):  # their prefill returns a zero cache
        cache = bundle.init_cache(params, B, cache_len)
    serve_step = make_serve_step(bundle)
    for t in range(3):
        tok, cache = serve_step(params, tok, cache, torch.full((B,), S + t))
        assert tok.shape == (B,)
        assert bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    assert (fa_mod.launches, ssd_mod.launches) == before


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v2-236b", "whisper-large-v3"])
def test_serve_from_prefill_continues_the_prefill(arch):
    """The prefill's cache serves on: the tokens equal those of decode
    stepped over the prompt (the reference's loop) for a model whose
    prefill builds its cache (whisper: its cross caches come only from a
    prefill, so the comparison is its own first token)."""
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(5), max_seq=64)
    batch = serve.make_batch(cfg, 2, 6, seed=5, device="cpu")
    gen = serve.serve_from_prefill(bundle, params, batch, 4, 32)
    assert gen.shape == (2, 4)
    first, _ = make_prefill_step(bundle, 32)(params, batch)
    assert torch.equal(gen[:, 0], first)
    if cfg.family != "encdec":
        stepped = serve.serve_loop(bundle, params, batch["tokens"], 5, 32)
        # the loop's first generated token comes from decoding the prompt's last
        assert torch.equal(stepped[:, :4], gen)


@pytest.mark.parametrize("arch,loop", [("llama3.2-1b", "from prefill"), ("granite-moe-1b-a400m", "from prefill"),
                                       ("whisper-large-v3", "from prefill"),
                                       ("mamba2-370m", "stepped prompt"), ("zamba2-7b", "stepped prompt")])
def test_serve_picks_the_loop_by_family(arch, loop):
    """``serve.serve``, the CLI's loop: from the prefill's cache where the
    family's prefill returns it, else decode stepped over the prompt (the
    ssm and hybrid prefills return a zero cache)."""
    cfg = get_config(arch).reduced()
    bundle = build_model(cfg)
    params = bundle.init(torch.Generator().manual_seed(6), max_seq=64)
    batch = serve.make_batch(cfg, 2, 6, seed=6, device="cpu")
    got = serve.serve(bundle, params, batch, 3, 32)
    if loop == "from prefill":
        want = serve.serve_from_prefill(bundle, params, batch, 3, 32)
    else:
        want = serve.serve_loop(bundle, params, batch["tokens"], 3, 32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_serve_cli_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--preset", "cpu-small", "--device", "cpu", "--batch", "2",
                "--prompt-len", "4", "--gen", "3", "--cache-len", "16"])
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


def test_build_server_sizes_the_decoder_positions():
    cfg, bundle, params = serve.build_server("whisper-large-v3", device="cpu", cache_len=24)
    assert tuple(params["dec_pos"]["pos_table"].shape) == (32, cfg.d_model)

"""Batched serving driver: greedy decoding with a fixed cache — the
counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --preset cpu-small --device cpu --batch 4 --prompt-len 16 --gen 32

``--arch`` is any architecture of the reference's zoo (``--help`` lists
them): the dense transformers llama3.2-1b (tied embeddings), qwen1.5-110b
(QKV bias), command-r-plus-104b and internvl2-76b (its vision frontend
stubbed, as in the reference); minicpm3-4b (MLA); the MoE transformers
granite-moe-1b-a400m and deepseek-v2-236b (MLA, shared experts, a dense
first layer); mamba2-370m (Mamba-2, tied embeddings); whisper-large-v3
(encoder–decoder; its frames are stub embeddings drawn from the seed);
and zamba2-7b (the default: Mamba-2 with shared attention).  ``--preset
full`` is the model at its published size, for the GPU; ``cpu-small`` the
reference's ``reduced()`` config.  Weights and prompts are drawn from
``--seed`` on the device; nothing is downloaded.

:func:`serve` picks the loop from the family.  Where the prefill returns
the serving cache (dense, moe, encdec) it prefills the prompt in one step
(on the GPU: B4 in every GQA layer, and whisper's encoder) and decodes on
from that cache.  Where it returns a zero cache (ssm, hybrid) it runs the
reference's loop: decode stepped over the prompt, then greedy serve steps.
The reference's driver runs its loop for every family, so it never runs
whisper's encoder (ROADMAP Queue C).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import ALL_ARCHS, get_config
from ..device import resolve_device
from ..models import build_model, make_prefill_step, make_serve_step

PRESETS = ("full", "cpu-small")
#: the families whose prefill returns the serving cache; the ssm and hybrid
#: prefills return a zero one, as the reference's (ROADMAP Queue C)
PREFILL_CACHE_FAMILIES = ("dense", "moe", "encdec")


def build_server(arch="zamba2-7b", preset="cpu-small", *, seed=0, device=None, cache_len=128):
    """(cfg, bundle, params): the model of ``arch`` at ``preset`` size with
    weights drawn from ``seed`` on ``device`` (CUDA unless the caller asks
    for the CPU; raises without a GPU).  An encoder–decoder gets
    ``cache_len + 8`` learned decoder positions, as ``repro.launch.serve``
    gives it."""
    device = resolve_device(device)
    if preset not in PRESETS:
        raise ValueError(f"preset must be one of {PRESETS}, got {preset!r}")
    cfg = get_config(arch)
    if preset == "cpu-small":
        cfg = cfg.reduced()
    bundle = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return cfg, bundle, bundle.init(gen, max_seq=cache_len + 8)


def make_prompts(cfg, batch, prompt_len, *, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=device)


def make_batch(cfg, batch, prompt_len, *, seed, device):
    """The prefill batch: {"tokens"} of ``make_prompts``, and for an
    encoder–decoder {"frames"} (B, encoder_seq, d), stub frame embeddings
    ~ N(0, 1) in the model's dtype, drawn from the seed."""
    out = {"tokens": make_prompts(cfg, batch, prompt_len, seed=seed, device=device)}
    if cfg.family == "encdec":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 2)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                                    device=device).to(dtype)
    return out


def serve_loop(bundle, params, prompts, gen_len, cache_len, *, on_step=None):
    """The reference's loop: step decode over prompts[:, :-1] (the cache-exact
    prefill), then ``gen_len`` greedy serve steps from prompts[:, -1].
    Returns the generated tokens (B, gen_len).  ``on_step(phase, t, out)``,
    if given, is called after every step: ("prefill", t, logits) or
    ("decode", t, tokens)."""
    B, prompt_len = prompts.shape
    serve_step = make_serve_step(bundle)
    cache = bundle.init_cache(params, B, cache_len)
    dev = prompts.device
    for t in range(prompt_len - 1):
        logits, cache = bundle.decode(params, prompts[:, t], cache,
                                      torch.full((B,), t, dtype=torch.int64, device=dev))
        if on_step:
            on_step("prefill", t, logits)
    generated = []
    tok = prompts[:, -1]
    for t in range(gen_len):
        pos = torch.full((B,), prompt_len - 1 + t, dtype=torch.int64, device=dev)
        tok, cache = serve_step(params, tok, cache, pos)
        generated.append(tok)
        if on_step:
            on_step("decode", t, tok)
    return torch.stack(generated, dim=1)


def serve_from_prefill(bundle, params, batch, gen_len, cache_len, *, on_step=None):
    """One prefill step over the batch's prompts (the cache it builds, and
    the first greedy token), then ``gen_len − 1`` greedy serve steps from
    that cache: the loop for ``PREFILL_CACHE_FAMILIES``.  Returns the generated tokens (B, gen_len).
    ``on_step(phase, t, tokens)``, if given, is called after the prefill
    ("prefill", 0, …) and every step ("decode", t, …)."""
    B, prompt_len = batch["tokens"].shape
    tok, cache = make_prefill_step(bundle, cache_len)(params, batch)
    if on_step:
        on_step("prefill", 0, tok)
    serve_step = make_serve_step(bundle)
    generated = [tok]
    dev = tok.device
    for t in range(gen_len - 1):
        pos = torch.full((B,), prompt_len + t, dtype=torch.int64, device=dev)
        tok, cache = serve_step(params, tok, cache, pos)
        generated.append(tok)
        if on_step:
            on_step("decode", t, tok)
    return torch.stack(generated, dim=1)


def serve(bundle, params, batch, gen_len, cache_len, *, on_step=None):
    """``gen_len`` greedy tokens (B, gen_len) for the prompts of ``batch``
    (``make_batch``): :func:`serve_from_prefill` where the family's prefill
    returns the serving cache (``PREFILL_CACHE_FAMILIES``), else
    :func:`serve_loop`.  ``on_step`` as theirs."""
    if bundle.cfg.family in PREFILL_CACHE_FAMILIES:
        return serve_from_prefill(bundle, params, batch, gen_len, cache_len, on_step=on_step)
    return serve_loop(bundle, params, batch["tokens"], gen_len, cache_len, on_step=on_step)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                 epilog=__doc__.split("\n\n", 2)[2],
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="zamba2-7b", choices=ALL_ARCHS,
                    help="architecture: every family of the reference's zoo (below)")
    ap.add_argument("--preset", default="cpu-small", choices=PRESETS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, bundle, params = build_server(args.arch, args.preset, seed=args.seed, device=dev,
                                       cache_len=args.cache_len)
    batch = make_batch(cfg, args.batch, args.prompt_len, seed=args.seed, device=dev)
    t0 = time.time()
    with torch.inference_mode():
        gen = serve(bundle, params, batch, args.gen, args.cache_len)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = args.batch * (args.prompt_len + args.gen)
    print(f"generated {tuple(gen.shape)} on {dev} in {dt:.2f}s  ({toks / dt:.1f} tok/s)")
    print("sample:", gen[0][:16].tolist())


if __name__ == "__main__":
    main()

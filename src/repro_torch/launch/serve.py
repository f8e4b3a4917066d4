"""Batched serving driver: greedy decoding with a fixed cache — the
counterpart of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --preset cpu-small --device cpu --batch 4 --prompt-len 16 --gen 32

``--preset full`` is the model at its published size (zamba2-7b: 81
layers, bf16, 14.2 GB of weights), for the GPU.  Weights and prompts are
drawn from ``--seed`` on the device; nothing is downloaded.  The loop is
the reference's: a cache-exact prefill that steps decode over the prompt,
then greedy serve steps.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import build_model, make_serve_step

PRESETS = ("full", "cpu-small")


def build_server(arch="zamba2-7b", preset="cpu-small", *, seed=0, device=None):
    """(cfg, bundle, params): the model of ``arch`` at ``preset`` size with
    weights drawn from ``seed`` on ``device`` (CUDA unless the caller asks
    for the CPU; raises without a GPU)."""
    device = resolve_device(device)
    if preset not in PRESETS:
        raise ValueError(f"preset must be one of {PRESETS}, got {preset!r}")
    cfg = get_config(arch)
    if preset == "cpu-small":
        cfg = cfg.reduced()
    bundle = build_model(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return cfg, bundle, bundle.init(gen)


def make_prompts(cfg, batch, prompt_len, *, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=device)


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--preset", default="cpu-small", choices=PRESETS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg, bundle, params = build_server(args.arch, args.preset, seed=args.seed, device=args.device)
    dev = params["lm_head"].device
    prompts = make_prompts(cfg, args.batch, args.prompt_len, seed=args.seed, device=dev)
    t0 = time.time()
    with torch.inference_mode():
        gen = serve_loop(bundle, params, prompts, args.gen, args.cache_len)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = args.batch * (args.prompt_len + args.gen)
    print(f"generated {tuple(gen.shape)} on {dev} in {dt:.2f}s  ({toks / dt:.1f} tok/s)")
    print("sample:", gen[0][:16].tolist())


if __name__ == "__main__":
    main()

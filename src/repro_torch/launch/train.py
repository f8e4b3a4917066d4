"""End-to-end LM training driver — the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --preset cpu-small --device cpu --steps 50 --ckpt-dir /tmp/ckpt --resume auto
    PYTHONPATH=src python -m repro_torch.launch.train --preset full --steps 10   # on the GPU

Wires every layer of the substrate together: the config registry → the
model zoo (``build_model``) → the data pipeline (``TokenStream``) → the
train step (``make_train_step``: value and gradient on the plain paths,
clipping, Adam) → checkpointing (async, atomic) → fault tolerance (the
preemption handler, the straggler watchdog, the crash-restart loop).
The flags are the reference's, plus ``--device``: CUDA by default (a
missing GPU raises ``NoCudaDeviceError``), ``cpu`` only if asked for.

Where the reference's driver differs, on purpose:
* each step reads its loss before the watchdog's ``step_end``, so the
  watchdog times the step's kernels and not their dispatch (on the card
  they run after the host returns);
* an encoder–decoder (whisper) also gets stub frame embeddings ~ N(0, 1),
  drawn with numpy from (seed, step) like the tokens (the reference's
  driver passes none, and its encdec loss needs them);
* a crash waits for the checkpoint writer in flight before it propagates,
  so the restarted attempt finds the checkpoint committed.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import TokenStream
from ..device import resolve_device
from ..distributed.fault import PreemptionHandler, StragglerWatchdog, restart_loop
from ..models import build_model, make_train_step


def make_cpu_small(cfg):
    return cfg.reduced()


def training_batch(cfg, stream: TokenStream, step: int, device) -> dict:
    """``stream.batch_at(step)`` on ``device`` (tokens int64); for an
    encoder–decoder also {"frames"} (B, encoder_seq, d) ~ N(0, 1) in the
    model's dtype, from (seed, step, shard)."""
    tokens = stream.batch_at(step)["tokens"]
    out = {"tokens": torch.from_numpy(tokens).to(device=device, dtype=torch.int64)}
    if cfg.family == "encdec":
        rng = np.random.default_rng([stream.seed, step, stream.shard, 1])
        frames = rng.standard_normal((tokens.shape[0], cfg.encoder_seq, cfg.d_model),
                                     dtype=np.float32)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        out["frames"] = torch.from_numpy(frames).to(device=device, dtype=dtype)
    return out


def run_training(args, attempt=0, *, log=None):
    """One attempt of the training run that ``args`` (``main``'s flags)
    describes; resumes from the latest complete checkpoint under
    ``--resume auto``.  Returns the final step reached.  ``log``, a list if
    given, receives one {"step", "loss", "grad_norm", "seconds"} per step
    (seconds synchronised: the loss is read first)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.preset == "cpu-small":
        cfg = make_cpu_small(cfg)
    bundle = build_model(cfg)

    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    train_step, init_opt = make_train_step(bundle, lr=args.lr)

    ckpt = Checkpointer(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = bundle.init(gen, max_seq=args.seq + 8)
    opt = init_opt(params)
    start_step = 0

    if ckpt and args.resume == "auto":
        latest = ckpt.latest_step()
        if latest is not None:
            state = ckpt.restore(latest, {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            start_step = latest + 1
            print(f"[resume] restored step {latest}", flush=True)

    watchdog = StragglerWatchdog()
    losses = []
    try:
        with PreemptionHandler() as preempt:
            for step in range(start_step, args.steps):
                watchdog.step_start()
                batch = training_batch(cfg, stream, step, device)
                params, opt, metrics = train_step(params, opt, batch)
                loss = float(metrics["loss"])  # waits for the step's kernels
                dt = watchdog.step_end(step)
                losses.append(loss)
                gnorm = float(metrics["grad_norm"])
                if log is not None:
                    log.append({"step": step, "loss": loss, "grad_norm": gnorm, "seconds": dt})
                if step % args.log_every == 0:
                    print(f"step {step:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}  {dt*1e3:.0f}ms",
                          flush=True)
                if ckpt and step > 0 and step % args.ckpt_every == 0:
                    ckpt.save_async(step, {"params": params, "opt": opt})
                if preempt.requested:
                    print(f"[preempt] checkpoint-and-exit at step {step}", flush=True)
                    if ckpt:
                        ckpt.save(step, {"params": params, "opt": opt})
                    return step
                if args.crash_at is not None and step == args.crash_at and attempt == 0:
                    raise RuntimeError("injected crash (fault-tolerance test)")
        if ckpt:
            ckpt.save(args.steps - 1, {"params": params, "opt": opt})
    finally:
        if ckpt:
            ckpt.wait()
    if losses:
        print(f"[done] steps={args.steps} first_loss={losses[0]:.4f} "
              f"last_loss={losses[-1]:.4f} stragglers={watchdog.straggler_count}", flush=True)
    return args.steps - 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--preset", default="cpu-small", choices=["cpu-small", "full"])
    ap.add_argument("--device", default=None, help='"cpu" runs without a GPU (default: CUDA)')
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", default="auto", choices=["auto", "never"])
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--crash-at", type=int, default=None,
                    help="inject a crash at this step (first attempt only)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    final = restart_loop(
        lambda attempt: run_training(args, attempt),
        max_restarts=args.max_restarts,
        on_restart=lambda n, e: print(f"[restart {n}] after {type(e).__name__}: {e}", flush=True),
    )
    print(f"[exit] final step {final}", flush=True)
    return final


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: builds its CUDA kernels, holds each
against its plain PyTorch version on the card, and drives the exact-GP
serving and training slices (single- and multi-output, multi-restart, and
partitioned to a million rows), streaming and threaded serving with the
degradation ladder and the chaos drill, SGPR, BLR, DKL and the multitask
GP, and zamba2-7b serving at full size through the kernels.

    python3 chip_smoke.py [--seed 0] [--n 40000]

Phases (each prints one JSON object per line; any failure exits non-zero
and the final line is then not printed):

  1. build      nvcc of every ``src/repro_torch/kernels/*/csrc`` source, one
                process per source, all at once; for the tensor-core kernels
                (B1/B2, B3, the gradient, bf16 B1/B2 and B3, bf16 B4, bf16
                B5) each function's
                registers, shared memory and spills (ptxas; none allowed but
                in B1) and its HMMA / HGMMA count in the SASS (cuobjdump),
                which must not be 0
  2. kernel     B1 (2-D M) and B2 (3-D M) against ``kernel_matmul_plain``
                for rbf / matern12/32/52 at odd n, ARD, t ∈ {1, 9, 17, 234,
                256, 512}; the multitask widths (n = 10,000 and 30,000 at
                t = 36, here and in kernel_bf16 and, symmetric, in
                grad_kernel);
                row_offset slices of the n=40,000 product; b=4 batches;
                tolerance 2e-4 relative (max |Δ| / max |plain|)
     fused_kernel  B3 against ``fused_cg_step_plain``: odd n, t ∈ {1, 9, 16,
                17, 33, 64}, b ∈ {1, 3}, the four kernel types, frozen and
                all-zero columns, the no-op prologue (γ = 0), row_offset
                shards that reassemble the full step, a separate column
                state (same bits); state rtol / atol 2e-4, reductions rtol
                2e-4 / atol 2e-3.  One case at n=40,000 held at those
                tolerances to a float64 evaluation (the f32 plain version is
                3-4e-4 from it there) and no further from it than the plain
                version; two runs bit-identical
     grad_kernel   the gradient kernel against ``kernel_matmul_grad_plain``:
                the four kernel types, scalar and ARD ℓ (through the chain
                to ℓ), rows ≠ columns, coincident points; the one-launch
                symmetric VJP against ``kernel_matmul_grad_sym_plain`` and
                the two-launch path (duplicated and near-coincident rows);
                both at n=40,000; tolerance 2e-4 relative
     kernel_bf16   bf16 B1/B2 (precision="mixed") against
                ``kernel_matmul_plain(..., compute_dtype="bfloat16")``: the
                sweep of ``kernel`` (four kernel types, odd n, ARD, t ∈ {1, 9,
                17, 234, 256}, b = 4, row_offset slices of n = 40,000
                reassembled bit for bit), X/ℓ rounded to bf16; 2e-3 relative
                and 2e-2 of the f32 product
     fused_kernel_bf16  bf16 B3 against its bf16 plain version, the sweep of
                ``fused_kernel``: the f32 state at rtol / atol 2e-4, V′ and
                the reductions 2e-3 relative; n = 40,000 held to a float64
                product of the bf16-rounded factors and, on row slices, to
                a float64 product of the kernel's own rounded entries (no
                further from it than the plain version); two runs
                bit-identical
     flash_kernel  B4 against ``gqa_attention_plain``: causal and not, GQA
                8/2 heads, dh ∈ {32, 64, 112, 224}, ragged lengths, the
                slice's (4, 32, 512, 224), bf16 on both routes (tensor
                cores; dh = 40 on the CUDA cores); f32 rtol/atol 2e-4, bf16
                3e-2
     ssd_kernel    B5 against ``ssd_scan_chunked_ref`` and the step
                recurrence, every case on both routes (the default, which
                takes aligned bf16 with dh, ds, chunk multiples of 16 to the
                tensor cores, and the CUDA-core kernel forced): chunk ∈ {32,
                64, 128}, the reference's shape sweep, the slice's (4, 112,
                512, 64, 64) in bf16, l = 4,096 in f32 and bf16; f32 2e-3,
                bf16 5e-2; the slice on the model's strided views no further
                from the f64 recurrence than 2 × the plain version, and two
                runs bit-identical, on each route
  3. timing     the kernels at the slices' shapes beside the plain version,
                (B1's bound prices its product as three TF32 products; bf16
                B1 at t = 9 / 234 / 256, B2 and B3 at t = 9 as one bf16
                product, beside the f32 kernel's time),
                a library yardstick (torch.cdist → kernel map → torch.matmul,
                autograd through it for the gradient; B4:
                scaled_dot_product_attention; B5: none) and the card's
                bound, CUDA events around synchronised launches; B5 on both
                routes in turns, the tensor cores faster or the phase fails
  4. serve      ExactGP(matern52, mode="cuda") on n=40,000, d=8 synthetic
                kin40k-shaped data: one posterior_cache build, eight
                1,024-point predict_cached requests, one 256-point predict;
                launch counts checked against the settings
     serve_mixed   the same slice at precision="mixed": bf16 B1 once per CG
                iteration, f32 B1 once per refresh (period 2) and for the
                Gram product, counted by dtype; cold and warm times, peak
                memory; the cached variance conservative against the exact
                posterior; the means beside "highest" and the exact
                posterior; cut to 5 iterations (where two correct paths
                agree) against the same path with every kernel replaced by
                its bf16 plain version (rtol 1e-2 / atol 1e-3) and against
                "highest" (means within 2e-2)
  5. prefix     the same slice cut to 5 CG iterations on the kernel path
                and on the plain (dense) path: the served means, the
                predictive variance, inv_quad, logdet and the cached
                variance on the Lanczos directions must agree at the slice
                tolerances (mean rtol 1e-3 / atol 1e-4, variance rtol 5e-3
                / atol 1e-4)
  6. witness    the full 25 iterations on the plain path, the same mBCG in
                f64 and the exact f64 posterior beside the kernel path's
                outputs; the cached variance must stay conservative
  7. train      ExactGP(matern52, mode="cuda", fuse_cg=True, precond_rank=0)
                .fit on the same data, 5 Adam steps, each synchronised and
                timed with its launches (B3 max_cg_iters per forward, one
                gradient-kernel launch in the backward); the anatomy of one step
                (no B1 in the fused forward); peak device memory (K never
                formed); a 5-iteration prefix of the first step held to
                the unfused path with every kernel replaced by its plain
                version (MLL rtol 1e-4, every gradient rtol 1e-3) and the
                fused solves to the unfused B1 solves (rtol 1e-3 / atol
                1e-4); one unfused step at precond_rank=5
     train_mixed   the training slice at precision="mixed": bf16 B3 once per
                CG iteration, f32 B1 once per refresh and for the backward's
                primal, one f32 gradient launch, counted by dtype per step;
                a profiled step; a 5-iteration prefix against the plain
                versions (loss rtol 1e-2, gradients 1e-2) and against
                "highest" (MLL within 1e-2 per data point); one unfused
                mixed step
  8. batched_kernel  B2 at the multi-output shape (n = 40,000, b = 4, t = 9)
                against four B1 launches (the same bits expected); B2's
                gradient (its autograd Function: one gradient-kernel launch
                over the batch folded into columns) against the plain
                version's VJPs summed over the batch, 2e-4 relative; bf16 B2
                against its bf16 plain version, 2e-3
     multi_output  ExactGP(matern52, mode="cuda").loss on the serving X with
                Y (4, n): (4,) from one engine call, unfused at
                precond_rank=5 (B2), fused (B3, b = 4) and mixed (bf16 B2,
                f32 B2 refreshes), launches counted, forward and backward
                timed; over a 5-iteration prefix each against the loop of
                4 single-output losses (rtol 1e-5, gradients rtol 2e-3 /
                atol 1e-4), mixed against highest (1e-2 per point);
                engine_state and solve with a batched right-hand side
     multi_restart  ExactGP.batched_loss, 4 hyperparameter sets at n = 8,192
                (4 dense K, no kernel), against a loop of loss: rtol 1e-5
                at precond_rank=0 (25 iterations and the prefix) and at
                precond_rank=5 (both factors pivot on k(x, x))
  9. panel_parity  n = 200,000, the reference's million recipe (X ~ N(0, I₄),
                RBF ℓ = 0.25, s = 1, σ² = 1), t = 9: the streamed K·M
                against the full-range B1 (rtol / atol 1e-4; 0 expected)
                and on 512 rows against float64 (2e-4); the panel-fused
                step against the full-range B3 (state 2e-4, reductions
                2e-3), one B3 launch per panel; the panel-streamed VJP
                against the symmetric VJP (rtol 2e-3 / atol 1e-4); one bf16
                panel-fused step against the bf16 B3 (2e-3); on the same
                512 rows each panel stream against float64: the fused
                step's V′ (2e-4) and U′, R′, D′ (2e-4), the VJP's rows
                (2e-4), the bf16 step's V′ (2e-3) and D′
     panel_sweep   the streamed K·M and the panel-fused step timed at panel
                heights 8,192 … 101,376, the card's default and n
     serve_partitioned  ExactGP(rbf, mode="cuda_partitioned") at n = 200,000:
                the engine over a 5-iteration prefix against mode="cuda"
                (MLL rtol 1e-4, solves rtol / atol 1e-4); the posterior
                cache at precond_rank=5 (one launch per panel per
                iteration), a 1,024-point predict_cached, times, status,
                peak memory
     train_partitioned  the same model with fuse_cg=True, precond_rank=0:
                the prefix MLL and gradients against mode="cuda"; two Adam
                steps from the recipe's hyperparameters (B3 per panel per
                iteration, the backward's primal and gradient per panel);
                one mixed panel-fused step
     million    n = 10⁶: one streamed K̂·M (512 rows against float64), a
                3-iteration panel-fused CG prefix (finite, the CG
                objective falling, num_panels launches per iteration, each
                iteration's V′ on 512 rows and U′, R′, D′ against float64),
                the true-residual product (launches counted, rows against
                float64) and the reported residual against it (rtol 1e-4 /
                atol 1e-6), peak device memory under 2 GB beside the panel
                and dense bytes
 10. gp_stream  gp_serve.run_serve at n = 40,000, d = 8 (its RBF toy, 8
                probes, 25 iterations, rank 5): 48 1,024-point requests,
                64 observations every 8, max_staleness 4 (appends and
                forced rebuilds), max_basis_columns 256 (every append
                compacts); each append exactly p + 2 f32 B1 launches, its
                cached variance conservative against the f64 posterior
                (1e-3), its α's true residual within APPEND_RES_FACTOR of a
                rebuild's at the same data and budget; points/s, ms per
                request, append against rebuild ms, CG iterations
     gp_threaded  run_serve_threaded, 4 query workers, double-buffered
                refreshes: no query raised, every refresh swapped or
                discarded (≥ 1 discarded), every answer replayed bit for bit
                from the state it reports, the launch counters equal to the
                sum of each call's own-thread counts
     gp_ladder  solve through a FaultInjectingOperator: mixed fused →
                precision_f32, f32 fused → unfused, extend_budget, at 2,048
                rows dense_cholesky and dense_direct; each rung's status
                and launches by kernel and dtype (the trace's launch
                markers), the healed answer's true residual
     gp_chaos   run_serve_chaos at n = 40,000 (mixed, degrade, 2 threads,
                CHAOS_CG_ITERS): chaos_ok, a CONVERGED clean build, the
                faults on bf16 B1 counted
     gp_metrics the drill again through gp_serve.main --metrics-port 0 on a
                thread, /metrics and /health scraped and rendered by gp_top:
                escalation, degraded-query and mbcg counters non-zero
 11. sgpr       SGPR(num_inducing=300) on kin40k-shaped data, n = 40,000
                (precond_rank=1, max_cg_iters=40), at "highest" and "mixed":
                the MLL against an f64 SoR MLL from the same root (rtol
                2e-3), at most 3 CG iterations (the root is the
                preconditioner), three Adam steps and one with the inducing
                points frozen (unchanged bit for bit), the Woodbury cache,
                a 1,024-point request against the f64 SoR posterior (1e-4),
                a 64-point append through PosteriorSession against a
                rebuild (rtol 1e-3 / atol 1e-4) with zero CG; no launch
     blr        BayesianLinearRegression at n = 40,000, d = 64: the same
     dkl        DKLExactGP(hidden=(32, 32, 2)) at n = 40,000, dense: the
                MLL and every weight's gradient over a 5-iteration prefix
                against float64 (rtol 2e-3 / atol 1e-4; the last bias's
                gradient 0 up to rounding), two Adam steps, a Krylov cache
                build and a 1,024-point request; no launch
     multitask  MultitaskGP(num_tasks=4, mode="cuda") on 10,000 locations
                × 4 tasks (8 probes, 25 iterations, rank 0): the prefix
                against mode="dense" (MLL 1e-4, gradients rtol 2e-3 / atol
                1e-4) and structure="hadamard" against Kronecker (1e-5); a
                training step (one B1 at t = 36 per CG iteration, the
                backward one B1 and one gradient launch, no B3), a cache
                build, a 1,024-row request (no launch), a 256-row predict
                (its mean predict_cached's bit for bit, the cached variance
                no lower than the exact f64 one − 1e-6); the Hadamard panel
                (30,000 rows); B1, bf16 B1 and the gradient timed at t = 36
     multitask_mixed  the same at precision="mixed": bf16 B1 per iteration,
                f32 refreshes, against "highest" (means 2e-2, MLL 1e-2 per
                point)
     gp_serve_zoo  run_serve for sgpr, blr, dkl and multitask (8 requests of
                1,024 points, 64 appended points every 2) and
                run_serve_threaded (4 workers) for sgpr, every answer
                replayed bit for bit; the Woodbury appends run no CG
 12. lm_parity  zamba2-7b at full width in f32, batch 2, a 256-token
                prompt, at 13 layers and at all 81: the forward with B4/B5
                and every B4/B5 call in it no further from the f64 witness
                (the plain path in f64) than 4 × the f32 plain forward and
                calls; at 13 layers also the forward vs its plain version
                (rtol/atol 1e-3) and vs decode stepped over the prompt at
                every position (2e-2)
 13. lm_serve   zamba2-7b at full size (81 layers, bf16, weights from the
                seed on the card): one make_prefill_step over 4 × 512-token
                prompts (81 B5 and 13 B4 launches, counted), then the serve
                loop (decode stepped over the prompts, 32 greedy tokens,
                cache 1,024); prefill ms, decode ms per token, tokens/s,
                peak memory; at every one of the 81 + 13 calls on the full
                model's own inputs, B5 / B4 within 5e-2 of the plain
                version's largest output, and each on the tensor-core route
                (``b4_route``, ``ssd_scan.b5_route``); the full-depth kernel-vs-plain
                logits within 2 × the plain path's own distance under a
                one-ulp change of its embedding (at random weights the
                bf16 model amplifies rounding to O(1)); a profile of one
                prefill and one decode step

The last line is ``{"ok": true, "device": {...}}``.  Run from a checkout of
the repository; needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, dense
# bf16 and TF32 on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
KERNEL_TYPES = ("rbf", "matern12", "matern32", "matern52")
REL_TOL = 2e-4
MEAN_TOL = dict(rtol=1e-3, atol=1e-4)
VAR_TOL = dict(rtol=5e-3, atol=1e-4)
PREFIX_ITERS = 5  # CG iterations over which the kernel and plain paths must agree
FUSED_STATE_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_fused_cg.py:84-86
FUSED_RED_TOL = dict(rtol=2e-4, atol=2e-3)
MLL_RTOL = 1e-4  # tests/test_fused_cg.py:309
SOLVE_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_fused_cg.py:311
GRAD_RTOL = 1e-3  # per parameter, relative to its gradient (the reason: PERF.md §2)
TRAIN_STEPS = 5
# bf16 B1/B2/B3 against their bf16 plain versions, max |Δ| / max |plain|:
# both round the same f32 kernel entries and right-hand side to bf16 and sum
# in f32; they part only where an entry's f32 value straddles a bf16
# rounding boundary (the kernel's SFU exp rounds other than torch's), which
# moves that one term by 2^-8 of itself — 10x the f32 gate, half a bf16 ulp
# of the output.  And within the reference's 2e-2 of the f32 product
# (tests/test_precision.py:89).
BF16_REL_TOL = 2e-3
BF16_F32_REL = 2e-2
# the mixed slices against highest over PREFIX_ITERS iterations (at 25 the
# solves converge in neither precision, and two correct paths part), at the
# reference's tolerances: served means 2e-2 relative
# (tests/test_precision.py:126), MLL 1e-2 per data point (:137); and the
# mixed kernel path against the same path with every kernel replaced by its
# bf16 plain version over the prefix, 10x the f32 prefix tolerances (as
# BF16_REL_TOL is 10x REL_TOL)
MIXED_MEAN_REL = 2e-2
MIXED_MLL_PER_POINT = 1e-2
MIXED_PREFIX_TOL = dict(rtol=1e-2, atol=1e-3)
MIXED_GRAD_RTOL = 1e-2
CSRC = "src/repro_torch/kernels/kernel_matmul/csrc/"
KERNEL_SOURCE = CSRC + "kernel_matmul.cu"
FUSED_SOURCE = CSRC + "fused_cg_step.cu"
GRAD_SOURCE = CSRC + "kernel_matmul_grad.cu"
KERNEL_BF16_SOURCE = CSRC + "kernel_matmul_bf16.cu"
FUSED_BF16_SOURCE = CSRC + "fused_cg_step_bf16.cu"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"


class CheckFailed(AssertionError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def inv_softplus(v: float) -> float:
    return math.log(math.expm1(v))


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


def time_ms(fn, *, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed(fn):
    """Run ``fn`` once between synchronisations: (result, host ms, device
    ms by CUDA events around it)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, start.elapsed_time(stop)


def _padded(t: int) -> int:
    return -(-t // 8) * 8


def kernel_bound(rows: int, cols: int, d: int, t: int, batch: int = 1, bf16: bool = False):
    """Least time for (K + σ²I)·M on an H100: the kernel tile (2d + 1 f32
    flops per entry on the CUDA cores, 67 TFLOP/s, needed once whatever the
    batch; plus one exp per entry on the SFU, counted in ``exps`` and not
    priced) and the product, 2t flops per entry per batch element, at f32
    accuracy on the tensor cores: three TF32 products (the 3xTF32 split) at
    495 TFLOP/s; with bf16 operands (``bf16``) one bf16 product at 989
    TFLOP/s.  Each input read and output written once, at the width the
    kernel reads it (bf16: M as bf16 rows of ⌈t/8⌉·8).  Returns (bound_ms,
    bound_by, exps)."""
    tile_ops = rows * cols * (2 * d + 1)
    product_ops = 2 * rows * cols * t * batch * (1 if bf16 else 3)
    m_bytes = 2 * cols * _padded(t) if bf16 else 4 * cols * t
    nbytes = 4 * (rows * d + cols * d + batch * rows * t) + batch * m_bytes
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS
    t_ops = (tile_ops / PEAK_F32_FLOPS + product_ops / peak) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"),
            rows * cols)


def fused_bound(n: int, d: int, t: int, batch: int = 1, bf16: bool = False):
    """Least time for one fused CG step (B3) on an H100, priced as B1:
    the kernel tile (2d + 1 flops per entry, f32 at 67 TFLOP/s, once
    whatever the batch) and the product K̂·D′ (2t flops per entry per batch
    element, three TF32 products at 495 TFLOP/s, or with ``bf16`` one bf16
    product at 989), plus the prologue and the four reductions (~14 f32
    flops per state element), against X read once, the state U, R, D, V and
    α, β, γ read once and U′, R′, D′, V′ and the reductions written once."""
    f32_ops = n * n * (2 * d + 1) + 14 * n * t * batch
    product_ops = 2 * n * n * t * batch * (1 if bf16 else 3)
    nbytes = 4 * (n * d + 8 * batch * n * t + 7 * batch * t)
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_TF32_FLOPS
    t_ops = (f32_ops / PEAK_F32_FLOPS + product_ops / peak) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def grad_bound(n: int, d: int, t: int):
    """Least time for B1's vector-Jacobian product for both inputs and the
    outputscale on an H100: per kernel entry the differences and the
    distance from them (3d) and f, f′ and the coefficient as the kernel
    executes them for Matérn-5/2 (~20, one exp), f32 at 67 TFLOP/s; the
    weight ⟨Cᵢ, Mⱼ⟩ (2t) and one FMA per feature for each gradient sum,
    rows and columns, which share the differences (2 × 2d), as products at
    f32 accuracy on the tensor cores: three TF32 products at 495 TFLOP/s.
    Against X, M and C read once and both gradients written once."""
    f32_ops = n * n * (3 * d + 20)
    tf32_ops = 3 * n * n * (2 * t + 4 * d)
    nbytes = 4 * (n * d + 2 * n * t + 2 * n * d)
    t_ops = (f32_ops / PEAK_F32_FLOPS + tf32_ops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


#: the kernels redesigned for the tensor cores, by library: the name their
#: functions carry, the SASS instruction each must contain, and whether
#: spills fail the build (B1's d > 8 instantiations at 16 columns spill 8
#: bytes, off the main path)
TENSOR_CORE_KERNELS = {"kernel_matmul": ("kernel_matmul_kernel", "HMMA", False),
                       "fused_cg_step": ("fused_cg_product_kernel", "HMMA", True),
                       "kernel_matmul_bf16": ("kernel_matmul_bf16_kernel", "HMMA", True),
                       "fused_cg_step_bf16": ("fused_cg_product_bf16_kernel", "HMMA", True),
                       "kernel_matmul_grad": ("kernel_matmul_grad_kernel", "HMMA", True),
                       "flash_attention": ("flash_fwd_tc_kernel", "HGMMA", True),
                       "ssd_scan": ("ssd_scan_tc_kernel", "HMMA", True)}


def _cuda_tool(name):
    cand = shutil.which(name) or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name)
    return cand if Path(cand).exists() else None


def _demangle(names):
    """{mangled: readable name without namespaces or arguments}."""
    names = sorted(names)
    tool = shutil.which("c++filt")
    plain = names
    if tool and names:
        plain = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                               check=True).stdout.splitlines()
    return {m: re.sub(r"\(anonymous namespace\)::|_NV_ANON_NAMESPACE::", "", p)
            .split("(")[0].removeprefix("void ") for m, p in zip(names, plain)}


def ptxas_report(log):
    """Per function of ``nvcc -Xptxas -v`` output: registers, shared memory
    and the stack frame and spills."""
    out, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


def sass_counts(path):
    """Per function of the library's SASS (``cuobjdump -sass``): the number
    of HGMMA (wgmma) and HMMA (mma.sync) instructions; None without
    cuobjdump."""
    tool = _cuda_tool("cuobjdump")
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : ([\w$]+)", ln)
        if m:
            cur = out.setdefault(m.group(1), {"HGMMA": 0, "HMMA": 0})
        elif cur is not None:
            for op in cur:
                cur[op] += len(re.findall(rf"\b{op}\b", ln))
    return out


def phase_build(build):
    """nvcc of every kernel source; for the tensor-core kernels each
    function's registers, shared memory and spills (ptxas; none allowed
    where TENSOR_CORE_KERNELS says so) and its count of tensor-core
    instructions in the SASS, which must not be 0."""
    t0 = time.perf_counter()
    infos = build.build_all()
    for name in infos:
        build.load_library(name)
    seconds = time.perf_counter() - t0
    libraries, failures = {}, []
    for name, info in infos.items():
        lib = {"file": info.path.name, "nvcc_seconds": round(info.seconds, 3),
               "ptxas": sorted({ln.strip() for ln in info.log.splitlines()
                                if "registers" in ln or "spill" in ln})}
        if name in TENSOR_CORE_KERNELS:
            tag, op, no_spills = TENSOR_CORE_KERNELS[name]
            ptx = ptxas_report(info.log)
            sass = sass_counts(info.path)
            kernels = {m: {**ptx.get(m, {}), **((sass or {}).get(m, {}))}
                       for m in set(ptx) | set(sass or {}) if tag in m}
            check(bool(kernels), f"{name}: no {tag} function in the build")
            readable = _demangle(kernels)
            lib["ptxas"] = {readable[m]: k for m, k in kernels.items()}
            lib["sass_tool"] = "cuobjdump -sass" if sass is not None else "not found"
            for m, k in kernels.items():
                if no_spills and (k.get("spill_stores", 0) or k.get("spill_loads", 0)):
                    failures.append(f"{readable[m]}: spills {k}")
                if sass is not None and k.get(op, 0) == 0:
                    failures.append(f"{readable[m]}: no {op} in its SASS")
        libraries[name] = lib
    emit({"phase": "build", "seconds": round(seconds, 3), "libraries": libraries})
    check(not failures, "; ".join(failures))


def rel_err(out, ref) -> tuple[float, float]:
    diff = float((out - ref).abs().max())
    return diff, diff / max(float(ref.abs().max()), 1e-30)


def phase_kernel(km, plain, rng, errs):
    dev = torch.device("cuda")
    cases = []

    def compare(name, out, ref, key):
        torch.cuda.synchronize()
        abs_err, rel = rel_err(out, ref)
        errs[key] = max(errs[key], abs_err)
        cases.append({"case": name, "max_abs_err": abs_err, "rel_err": rel})
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
        check(rel <= REL_TOL, f"{name}: relative error {rel:.3e} > {REL_TOL}")

    d = 8
    for n in (1001, 4097):
        X = rng.standard_normal((n, d)).astype("float32")
        ell = rng.uniform(0.4, 1.5, d).astype("float32")
        Xs = torch.from_numpy(X / ell).to(dev)
        for t in (1, 9, 17, 234, 256, 512):
            M = torch.from_numpy(rng.standard_normal((n, t)).astype("float32")).to(dev)
            for kt in KERNEL_TYPES:
                out = km.kernel_matmul_cuda(Xs, Xs, M, 1.1, 0.1, kernel_type=kt)
                ref = plain(Xs, Xs, M, 1.1, 0.1, kernel_type=kt)
                compare(f"B1 {kt} n={n} t={t}", out, ref, "B1")

    # row_offset slices of the full n = 40,000 product: the σ² diagonal
    # lands at global coordinates, ragged last slice, plain side small
    n = 40_000
    X = rng.uniform(-1, 1, (n, d)).astype("float32")
    Xs = torch.from_numpy(X / 0.5).to(dev)
    for t in (9, 234):
        M = torch.from_numpy(rng.standard_normal((n, t)).astype("float32")).to(dev)
        full = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.1, kernel_type="matern52")
        for off, rows in ((0, 4096), (17_000, 4096), (36_000, 4000)):
            X1 = Xs[off : off + rows].contiguous()
            for kt in ("matern52", "rbf"):
                part = km.kernel_matmul_cuda(X1, Xs, M, 1.0, 0.1, off, kernel_type=kt)
                ref = plain(X1, Xs, M, 1.0, 0.1, off, kernel_type=kt)
                compare(f"B1 {kt} n={n} rows={off}:{off + rows} t={t}", part, ref, "B1")
                if kt == "matern52":
                    compare(f"B1 reassembly rows={off}:{off + rows} t={t}",
                            part, full[off : off + rows], "B1")

    # B2: a (b, n, t) right-hand side against per-slice B1 calls and plain
    for n, t in ((4097, 9), (1001, 234)):
        X = rng.standard_normal((n, d)).astype("float32")
        Xs = torch.from_numpy(X / 0.7).to(dev)
        M = torch.from_numpy(rng.standard_normal((4, n, t)).astype("float32")).to(dev)
        for kt in KERNEL_TYPES:
            out = km.kernel_matmul_cuda(Xs, Xs, M, 0.9, 0.05, kernel_type=kt)
            ref = plain(Xs, Xs, M, 0.9, 0.05, kernel_type=kt)
            compare(f"B2 {kt} b=4 n={n} t={t}", out, ref, "B2")
            for i in range(4):
                one = km.kernel_matmul_cuda(Xs, Xs, M[i], 0.9, 0.05, kernel_type=kt)
                compare(f"B2 {kt} slice {i} vs B1 n={n} t={t}", out[i], one, "B2")

    # the multitask widths: the Kronecker product's n = 10,000 locations and
    # the Hadamard panel's m = 30,000 rows at T·(1 + probes) = 36 columns,
    # σ² = 0 (the per-task noise is added outside the data kernel)
    for n in (MT_N, MT_HADAMARD_ROWS):
        Xs = torch.from_numpy((rng.uniform(-1, 1, (n, d)) / 0.5).astype("float32")).to(dev)
        M = torch.from_numpy(rng.standard_normal((n, MT_WIDTH)).astype("float32")).to(dev)
        out = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.0, kernel_type="rbf")
        ref = plain(Xs, Xs, M, 1.0, 0.0, kernel_type="rbf")
        compare(f"B1 rbf multitask n={n} t={MT_WIDTH}", out, ref, "B1")
        del Xs, M, out, ref
    torch.cuda.empty_cache()
    emit({"phase": "kernel", "cases": len(cases), "tolerance_rel": REL_TOL,
          "max_rel_err": max(c["rel_err"] for c in cases),
          "max_abs_err": {k: v for k, v in errs.items()}})


def phase_kernel_bf16(km, plain, rng, errs):
    """bf16 B1 (2-D M) and B2 (3-D M) against ``kernel_matmul_plain(...,
    compute_dtype="bfloat16")``, the sweep of phase ``kernel``: the four
    kernel types at odd n, ARD, t ∈ {1, 9, 17, 234, 256}, b = 4, row_offset
    slices of the n = 40,000 product (reassembled bit for bit); each within
    BF16_REL_TOL of its bf16 plain version and BF16_F32_REL of the f32
    product, the inputs prescaled as the mixed policy stores them (X/ℓ
    rounded to bf16)."""
    from repro_torch.kernels.kernel_matmul.ops import prescale_inputs

    dev = torch.device("cuda")
    cases = []

    def compare(name, out, ref, f32, key):
        torch.cuda.synchronize()
        abs_err, rel = rel_err(out, ref)
        rel32 = rel_err(out, f32)[1] if f32 is not None else 0.0
        errs[key] = max(errs[key], abs_err)
        cases.append({"case": name, "max_abs_err": abs_err, "rel_err": rel, "rel_err_vs_f32": rel32})
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
        check(rel <= BF16_REL_TOL, f"{name}: relative error {rel:.3e} > {BF16_REL_TOL}")
        check(rel32 <= BF16_F32_REL, f"{name}: {rel32:.3e} from the f32 product > {BF16_F32_REL}")

    d = 8
    for n in (1001, 4097):
        X = torch.from_numpy(rng.standard_normal((n, d)).astype("float32")).to(dev)
        ell = torch.from_numpy(rng.uniform(0.4, 1.5, d).astype("float32")).to(dev)
        Xs = prescale_inputs(X, ell, "bfloat16")
        for t in (1, 9, 17, 234, 256):
            M = torch.from_numpy(rng.standard_normal((n, t)).astype("float32")).to(dev)
            for kt in KERNEL_TYPES:
                out = km.kernel_matmul_cuda(Xs, Xs, M, 1.1, 0.1, kernel_type=kt, compute_dtype="bfloat16")
                ref = plain(Xs, Xs, M, 1.1, 0.1, kernel_type=kt, compute_dtype="bfloat16")
                f32 = plain(Xs, Xs, M, 1.1, 0.1, kernel_type=kt)
                compare(f"B1 bf16 {kt} n={n} t={t}", out, ref, f32, "B1_bf16")

    n = 40_000
    X = torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype("float32")).to(dev)
    Xs = prescale_inputs(X, 0.5, "bfloat16")
    for t in (9, 234):
        M = torch.from_numpy(rng.standard_normal((n, t)).astype("float32")).to(dev)
        full = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.1, kernel_type="matern52", compute_dtype="bfloat16")
        for off, rows in ((0, 4096), (17_000, 4096), (36_000, 4000)):
            X1 = Xs[off : off + rows].contiguous()
            part = km.kernel_matmul_cuda(X1, Xs, M, 1.0, 0.1, off, kernel_type="matern52",
                                         compute_dtype="bfloat16")
            ref = plain(X1, Xs, M, 1.0, 0.1, off, kernel_type="matern52", compute_dtype="bfloat16")
            f32 = plain(X1, Xs, M, 1.0, 0.1, off, kernel_type="matern52")
            compare(f"B1 bf16 matern52 n={n} rows={off}:{off + rows} t={t}", part, ref, f32, "B1_bf16")
            check(torch.equal(part, full[off : off + rows]),
                  f"B1 bf16 rows={off}:{off + rows} t={t}: the slice differs from the full product")

    for n, t in ((4097, 9), (1001, 234)):
        X = torch.from_numpy(rng.standard_normal((n, d)).astype("float32")).to(dev)
        Xs = prescale_inputs(X, 0.7, "bfloat16")
        M = torch.from_numpy(rng.standard_normal((4, n, t)).astype("float32")).to(dev)
        for kt in KERNEL_TYPES:
            out = km.kernel_matmul_cuda(Xs, Xs, M, 0.9, 0.05, kernel_type=kt, compute_dtype="bfloat16")
            ref = plain(Xs, Xs, M, 0.9, 0.05, kernel_type=kt, compute_dtype="bfloat16")
            f32 = plain(Xs, Xs, M, 0.9, 0.05, kernel_type=kt)
            compare(f"B2 bf16 {kt} b=4 n={n} t={t}", out, ref, f32, "B2_bf16")
            for i in range(4):
                one = km.kernel_matmul_cuda(Xs, Xs, M[i], 0.9, 0.05, kernel_type=kt,
                                            compute_dtype="bfloat16")
                check(torch.equal(out[i], one), f"B2 bf16 {kt} slice {i}: differs from bf16 B1")

    # the multitask widths under precision="mixed" (phase kernel's cases)
    for n in (MT_N, MT_HADAMARD_ROWS):
        X = torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype("float32")).to(dev)
        Xs = prescale_inputs(X, 0.5, "bfloat16")
        M = torch.from_numpy(rng.standard_normal((n, MT_WIDTH)).astype("float32")).to(dev)
        out = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.0, kernel_type="rbf", compute_dtype="bfloat16")
        ref = plain(Xs, Xs, M, 1.0, 0.0, kernel_type="rbf", compute_dtype="bfloat16")
        f32 = plain(Xs, Xs, M, 1.0, 0.0, kernel_type="rbf")
        compare(f"B1 bf16 rbf multitask n={n} t={MT_WIDTH}", out, ref, f32, "B1_bf16")
        del X, Xs, M, out, ref, f32
    torch.cuda.empty_cache()
    emit({"phase": "kernel_bf16", "cases": len(cases), "tolerance_rel": BF16_REL_TOL,
          "tolerance_rel_vs_f32": BF16_F32_REL,
          "max_rel_err": max(c["rel_err"] for c in cases),
          "max_rel_err_vs_f32": max(c["rel_err_vs_f32"] for c in cases),
          "max_abs_err": {"B1_bf16": errs["B1_bf16"], "B2_bf16": errs["B2_bf16"]}})


def _randn(rng, shape, dev, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype("float32")).to(dev)


def _cg_inputs(rng, dev, b, n, t):
    """A random fused-step state (U, R, D, V) and pending scalars α, β, γ."""
    state = [_randn(rng, (b, n, t), dev) for _ in range(4)]
    alpha = _randn(rng, (b, t), dev)
    beta = _randn(rng, (b, t), dev, 0.5)
    return state, [alpha, beta, torch.ones_like(alpha)]


def _advance_f64(state, scalars):
    """U′, R′, D′ of one CG step in float64 from its f32 inputs (U, R, D, V)
    and α, β, γ, elementwise: U′ = U + α∘D, R′ = R − α∘V, D′ = γ∘R′ + β∘D."""
    U, R, D, V = (x.double() for x in state)
    a, b, g = (x.double()[..., None, :] for x in scalars)
    R = R - a * V
    return U + a * D, R, g * R + b * D


def fused_step_f64(Xs, state, scalars, kernel_type, outputscale, sigma2, rows=2048):
    """One CG step of K̂ = K(Xs, Xs) + σ²I (single device, b = 1) in float64
    from the f32 inputs, K from differences a row slice at a time: the
    exact step the kernel and the plain version both approximate."""
    from repro_torch.kernels.kernel_matmul.ref import _sq_dist, apply_stationary

    U, R, D = _advance_f64(state, scalars)
    X = Xs.double()
    V = torch.empty_like(D)
    for i in range(0, X.shape[0], rows):
        K = apply_stationary(kernel_type, _sq_dist(X[i : i + rows], X), outputscale)
        K.diagonal(i).add_(sigma2)
        V[0, i : i + rows] = K @ D[0]
    red = torch.stack([(D * V).sum(-2), (R * R).sum(-2), (R * V).sum(-2), (V * V).sum(-2)], dim=-2)
    return U, R, D, V, red


def phase_fused_kernel(km, rng, errs):
    """B3 against its plain version, case by case (the state at rtol /
    atol 2e-4, the reductions at rtol 2e-4 / atol 2e-3)."""
    from repro_torch.kernels.kernel_matmul.ref import fused_cg_step_plain

    dev = torch.device("cuda")
    d = 8
    cases = []

    def run(Xr, Xc, state, cols, scalars, kt, off=0, s=1.1, s2=0.1):
        out = km.fused_cg_step_cuda(Xr, Xc, *state, *cols, *scalars, s, s2, off, kernel_type=kt)
        ref = fused_cg_step_plain(Xr, Xc, *state, *cols, *scalars, s, s2, off, kernel_type=kt)
        return out, ref

    def compare(name, out, ref):
        torch.cuda.synchronize()
        state_err = max(_err(a, b) for a, b in zip(out[:4], ref[:4]))
        red_rel = float(((out[4] - ref[4]).abs() / ref[4].abs().clamp(min=1e-30)).max())
        errs["B3"] = max(errs["B3"], state_err)
        cases.append({"case": name, "state_max_abs_err": state_err, "red_max_rel_err": red_rel})
        check(all(bool(torch.isfinite(a).all()) for a in out), f"{name}: non-finite B3 output")
        for a, b, nm in zip(out, ref, ("U", "R", "D", "V", "red")):
            tol = FUSED_RED_TOL if nm == "red" else FUSED_STATE_TOL
            check(_within(a, b, tol), f"{name}: B3 {nm} outside {tol} (max |Δ| {_err(a, b):.3e})")

    for n in (1001, 4097):
        Xs = torch.from_numpy(rng.standard_normal((n, d)).astype("float32") / 0.7).to(dev)
        for t in (1, 9, 16, 17, 33, 64):
            for b in (1, 3):
                state, scalars = _cg_inputs(rng, dev, b, n, t)
                for kt in KERNEL_TYPES:
                    out, ref = run(Xs, Xs, state, state[1:], scalars, kt)
                    compare(f"B3 {kt} n={n} t={t} b={b}", out, ref)

    # column 0 frozen (α = β = γ = 0), column 1 an all-zero padded column
    n, t, b = 1001, 9, 2
    Xs = torch.from_numpy(rng.standard_normal((n, d)).astype("float32")).to(dev)
    state, scalars = _cg_inputs(rng, dev, b, n, t)
    for x in scalars:
        x[:, :2] = 0.0
    for x in state:
        x[:, :, 1] = 0.0
    out, ref = run(Xs, Xs, state, state[1:], scalars, "matern52")
    compare("B3 frozen and zero columns", out, ref)
    check(torch.equal(out[0][..., 0], state[0][..., 0]) and torch.equal(out[1][..., 0], state[1][..., 0]),
          "B3: a frozen column's U or R changed")
    check(all(bool((x[..., 1] == 0).all()) for x in out),
          "B3: an all-zero column with α = β = γ = 0 gave a non-zero output or reduction")

    # γ = 0, α = 0, β = 1: the no-op prologue leaves U, R, D as they were
    state, scalars = _cg_inputs(rng, dev, 1, n, t)
    scalars = [torch.zeros_like(scalars[0]), torch.ones_like(scalars[0]), torch.zeros_like(scalars[0])]
    out, ref = run(Xs, Xs, state, state[1:], scalars, "rbf")
    compare("B3 no-op prologue", out, ref)
    check(all(torch.equal(a, b) for a, b in zip(out[:3], state[:3])),
          "B3: the no-op prologue (α=0, β=1, γ=0) changed U, R or D")

    # row_offset shards of an odd n reassemble the full step
    n = 4097
    Xs = torch.from_numpy(rng.standard_normal((n, d)).astype("float32") / 0.7).to(dev)
    state, scalars = _cg_inputs(rng, dev, 3, n, t)
    full = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.1,
                                 kernel_type="matern32")
    parts = []
    for lo, hi in ((0, 1366), (1366, 2732), (2732, n)):
        rows = [x[:, lo:hi].contiguous() for x in state]
        out, ref = run(Xs[lo:hi].contiguous(), Xs, rows, state[1:], scalars, "matern32", lo)
        compare(f"B3 shard rows={lo}:{hi}", out, ref)
        parts.append(out)
    whole = [torch.cat([p[k] for p in parts], dim=1) for k in range(4)]
    whole.append(sum(p[4] for p in parts))
    compare("B3 shards reassembled vs the full step", whole, full)

    # a column state in other buffers than the row state (the kernel forms
    # the columns' D′ in scratch then) gives the same bits as the shared one
    sep = [x.clone() for x in state[1:]]
    out, _ = run(Xs, Xs, state, sep, scalars, "matern32")
    check(all(torch.equal(a, b) for a, b in zip(out, full)),
          "B3: a separate column state changed the step's bits")

    # the slice's shape; a second run gives the same bits (no atomics).  At
    # n = 40,000 the plain version's f32 product (torch.matmul summing
    # 40,000 columns) lies 3-4e-4 from the exact V, past the state
    # tolerance's atol: a kernel that sums in its order agrees with it, a
    # more accurate one cannot.  So here the kernel is held, at the same
    # tolerances, to a float64 evaluation of the step, and must be no
    # further from it than the plain version is (PERF.md §6)
    n = 40_000
    X = rng.uniform(-1, 1, (n, d)).astype("float32")
    Xs = torch.from_numpy(X / 0.5).to(dev)
    state, scalars = _cg_inputs(rng, dev, 1, n, 9)
    out, ref = run(Xs, Xs, state, state[1:], scalars, "matern52", s=1.0)
    exact = fused_step_f64(Xs, state, scalars, "matern52", 1.0, 0.1)
    name = "B3 matern52 n=40000 t=9"
    torch.cuda.synchronize()
    witness = {"kernel_vs_plain": [_err(a, b) for a, b in zip(out, ref)],
               "kernel_vs_f64": [_err(a, b) for a, b in zip(out, exact)],
               "plain_vs_f64": [_err(a, b) for a, b in zip(ref, exact)]}
    errs["B3"] = max(errs["B3"], max(witness["kernel_vs_f64"][:4]))
    cases.append({"case": name, "state_max_abs_err": max(witness["kernel_vs_f64"][:4]),
                  "red_max_rel_err": float(((out[4] - exact[4]).abs() / exact[4].abs()).max())})
    check(all(bool(torch.isfinite(a).all()) for a in out), f"{name}: non-finite B3 output")
    for a, b, nm in zip(out, exact, ("U", "R", "D", "V", "red")):
        tol = FUSED_RED_TOL if nm == "red" else FUSED_STATE_TOL
        check(_within(a, b, tol), f"{name}: B3 {nm} outside {tol} of float64 (max |Δ| {_err(a, b):.3e})")
    check(witness["kernel_vs_f64"][3] <= witness["plain_vs_f64"][3],
          f"{name}: B3's V further from float64 than the plain version's {witness}")
    again = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.0, 0.1,
                                  kernel_type="matern52")
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          "B3: two runs on the same inputs differ")
    del out, ref, again, exact
    torch.cuda.empty_cache()
    emit({"phase": "fused_kernel", "cases": len(cases), "state_tol": FUSED_STATE_TOL,
          "red_tol": FUSED_RED_TOL, "state_max_abs_err": errs["B3"],
          "n40000_max_abs_err_U_R_D_V_red": witness,
          "red_max_rel_err": max(c["red_max_rel_err"] for c in cases)})


def fused_step_f64_bf16(Xs, state, scalars, kernel_type, outputscale, sigma2, D_kernel,
                        rows=2048):
    """One bf16 CG step (b = 1) in float64 from the bf16-rounded factors:
    the kernel tile formed in f32 as the plain version forms it (σ² on the
    diagonal) and rounded to bf16, and the kernel's own D′ rounded to bf16
    (so that both sides multiply the same D′ bits), their product summed in
    float64; U′, R′, D′ and the reductions as ``fused_step_f64``."""
    from repro_torch.kernels.kernel_matmul.ref import _sq_dist, apply_stationary

    U, R, D = _advance_f64(state, scalars)
    Db = D_kernel.to(torch.bfloat16).double()
    V = torch.empty_like(D)
    for i in range(0, Xs.shape[0], rows):
        K = apply_stationary(kernel_type, _sq_dist(Xs[i : i + rows], Xs), outputscale)
        K.diagonal(i).add_(sigma2)
        V[0, i : i + rows] = K.to(torch.bfloat16).double() @ Db[0]
    red = torch.stack([(D * V).sum(-2), (R * R).sum(-2), (R * V).sum(-2), (V * V).sum(-2)], dim=-2)
    return U, R, D, V, red


def kernel_entries_bf16(km, X1, X2, kernel_type, outputscale, sigma2, row_offset, chunk=16):
    """The bf16 kernel's own rounded entries of (K + σ²I)[rows, :], in
    float64: bf16 B1 with M the identity's columns, ``chunk`` at a time
    (16: the column block B3 runs at t = 9, so the same instantiation of
    the entry code); each output is one bf16 entry times 1, summed with
    zeros, so it is that entry exactly."""
    cols = X2.shape[0]
    out = torch.empty((X1.shape[0], cols), dtype=torch.float64, device=X1.device)
    eye = torch.eye(chunk, device=X1.device)
    for j0 in range(0, cols, chunk):
        w = min(chunk, cols - j0)
        M = torch.zeros((cols, chunk), device=X1.device)
        M[j0 : j0 + w] = eye[:w]
        part = km.kernel_matmul_cuda(X1, X2, M, outputscale, sigma2, row_offset,
                                     kernel_type=kernel_type, compute_dtype="bfloat16")
        out[:, j0 : j0 + w] = part[:, :w].double()
    return out


def phase_fused_kernel_bf16(km, rng, errs):
    """bf16 B3 against ``fused_cg_step_plain(..., compute_dtype="bfloat16")``,
    the sweep of phase ``fused_kernel``: the f32 state U′, R′, D′ at
    FUSED_STATE_TOL, V′ and each of the four reductions within BF16_REL_TOL
    of its largest, V′ within BF16_F32_REL of the f32 step's.  At n = 40,000
    it is held, at those tolerances (V′ within BF16_REL_TOL of its largest),
    to a float64 evaluation of the bf16-rounded factors (the plain formula's
    tile, the kernel's D′), and on row slices, at the state tolerance, to a
    float64 product of the kernel's own rounded entries, no further from it
    than the plain version; two runs bit-identical."""
    from repro_torch.kernels.kernel_matmul.ops import prescale_inputs
    from repro_torch.kernels.kernel_matmul.ref import fused_cg_step_plain

    dev = torch.device("cuda")
    d = 8
    cases = []

    def run(Xr, Xc, state, cols, scalars, kt, off=0, s=1.1, s2=0.1):
        out = km.fused_cg_step_cuda(Xr, Xc, *state, *cols, *scalars, s, s2, off, kernel_type=kt,
                                    compute_dtype="bfloat16")
        ref = fused_cg_step_plain(Xr, Xc, *state, *cols, *scalars, s, s2, off, kernel_type=kt,
                                  compute_dtype="bfloat16")
        return out, ref

    def compare(name, out, ref, f32_V=None):
        torch.cuda.synchronize()
        state_err = max(_err(a, b) for a, b in zip(out[:3], ref[:3]))
        v_rel = rel_err(out[3], ref[3])[1]
        red_rel = max(rel_err(out[4][:, k], ref[4][:, k])[1] for k in range(4))
        errs["B3_bf16"] = max(errs["B3_bf16"], state_err, _err(out[3], ref[3]))
        cases.append({"case": name, "state_max_abs_err": state_err, "V_rel_err": v_rel,
                      "red_rel_err": red_rel})
        check(all(bool(torch.isfinite(a).all()) for a in out), f"{name}: non-finite bf16 B3 output")
        for a, b, nm in zip(out[:3], ref[:3], "URD"):
            check(_within(a, b, FUSED_STATE_TOL), f"{name}: bf16 B3 {nm} outside {FUSED_STATE_TOL}")
        check(v_rel <= BF16_REL_TOL and red_rel <= BF16_REL_TOL,
              f"{name}: bf16 B3 V′ {v_rel:.3e} / reductions {red_rel:.3e} > {BF16_REL_TOL}")
        if f32_V is not None:
            rel32 = rel_err(out[3], f32_V)[1]
            check(rel32 <= BF16_F32_REL, f"{name}: V′ {rel32:.3e} from the f32 step")

    for n in (1001, 4097):
        X = torch.from_numpy(rng.standard_normal((n, d)).astype("float32")).to(dev)
        Xs = prescale_inputs(X, 0.7, "bfloat16")
        for t in (1, 9, 16, 17, 33, 64):
            for b in (1, 3):
                state, scalars = _cg_inputs(rng, dev, b, n, t)
                for kt in KERNEL_TYPES:
                    out, ref = run(Xs, Xs, state, state[1:], scalars, kt)
                    f32 = fused_cg_step_plain(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.1,
                                              kernel_type=kt)
                    compare(f"B3 bf16 {kt} n={n} t={t} b={b}", out, ref, f32[3])

    # column 0 frozen (α = β = γ = 0), column 1 an all-zero padded column
    n, t, b = 1001, 9, 2
    Xs = prescale_inputs(torch.from_numpy(rng.standard_normal((n, d)).astype("float32")).to(dev),
                         1.0, "bfloat16")
    state, scalars = _cg_inputs(rng, dev, b, n, t)
    for x in scalars:
        x[:, :2] = 0.0
    for x in state:
        x[:, :, 1] = 0.0
    out, ref = run(Xs, Xs, state, state[1:], scalars, "matern52")
    compare("B3 bf16 frozen and zero columns", out, ref)
    check(torch.equal(out[0][..., 0], state[0][..., 0]) and torch.equal(out[1][..., 0], state[1][..., 0]),
          "bf16 B3: a frozen column's U or R changed")
    check(all(bool((x[..., 1] == 0).all()) for x in out),
          "bf16 B3: an all-zero column with α = β = γ = 0 gave a non-zero output or reduction")

    # the no-op prologue (α = 0, β = 1, γ = 0) the refresh loop re-enters with
    state, scalars = _cg_inputs(rng, dev, 1, n, t)
    scalars = [torch.zeros_like(scalars[0]), torch.ones_like(scalars[0]), torch.zeros_like(scalars[0])]
    out, ref = run(Xs, Xs, state, state[1:], scalars, "rbf")
    compare("B3 bf16 no-op prologue", out, ref)
    check(all(torch.equal(a, b) for a, b in zip(out[:3], state[:3])),
          "bf16 B3: the no-op prologue (α=0, β=1, γ=0) changed U, R or D")

    # row_offset shards reassemble the full step bit for bit; a separate
    # column state gives the same bits as the shared one
    n = 4097
    Xs = prescale_inputs(torch.from_numpy(rng.standard_normal((n, d)).astype("float32")).to(dev),
                         0.7, "bfloat16")
    state, scalars = _cg_inputs(rng, dev, 3, n, t)
    full = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.1, 0.1,
                                 kernel_type="matern32", compute_dtype="bfloat16")
    parts = []
    for lo, hi in ((0, 1366), (1366, 2732), (2732, n)):
        rows = [x[:, lo:hi].contiguous() for x in state]
        out, ref = run(Xs[lo:hi].contiguous(), Xs, rows, state[1:], scalars, "matern32", lo)
        compare(f"B3 bf16 shard rows={lo}:{hi}", out, ref)
        parts.append(out)
    check(all(torch.equal(torch.cat([p[k] for p in parts], dim=1), full[k]) for k in range(4)),
          "bf16 B3: the row shards do not reassemble the full step")
    sep = [x.clone() for x in state[1:]]
    out, _ = run(Xs, Xs, state, sep, scalars, "matern32")
    check(all(torch.equal(a, b) for a, b in zip(out, full)),
          "bf16 B3: a separate column state changed the step's bits")

    # the slice's shape, against float64 of the bf16-rounded factors
    n = 40_000
    X = torch.from_numpy(rng.uniform(-1, 1, (n, d)).astype("float32")).to(dev)
    Xs = prescale_inputs(X, 0.5, "bfloat16")
    state, scalars = _cg_inputs(rng, dev, 1, n, 9)
    out, ref = run(Xs, Xs, state, state[1:], scalars, "matern52", s=1.0)
    exact = fused_step_f64_bf16(Xs, state, scalars, "matern52", 1.0, 0.1, out[2])
    name = "B3 bf16 matern52 n=40000 t=9"
    torch.cuda.synchronize()
    witness = {"kernel_vs_plain": [_err(a, b) for a, b in zip(out, ref)],
               "kernel_vs_f64": [_err(a, b) for a, b in zip(out, exact)],
               "plain_vs_f64": [_err(a, b) for a, b in zip(ref, exact)],
               "V_rms_kernel_vs_f64": _rms(out[3], exact[3]),
               "V_rms_plain_vs_f64": _rms(ref[3], exact[3])}
    errs["B3_bf16"] = max(errs["B3_bf16"], max(witness["kernel_vs_f64"][:4]))
    cases.append({"case": name, "state_max_abs_err": max(witness["kernel_vs_f64"][:4])})
    check(all(bool(torch.isfinite(a).all()) for a in out), f"{name}: non-finite bf16 B3 output")
    for a, b, nm in zip(out, exact, ("U", "R", "D", "V", "red")):
        if nm == "V":
            # an entry whose f32 value the kernel and the plain formula round
            # to neighbouring bf16 values moves its term by 2^-8: V′ is held
            # as the products are, relative to its largest
            rel = rel_err(a, b)[1]
            check(rel <= BF16_REL_TOL, f"{name}: V′ {rel:.3e} from float64 > {BF16_REL_TOL}")
            continue
        tol = FUSED_RED_TOL if nm == "red" else FUSED_STATE_TOL
        check(_within(a, b, tol), f"{name}: {nm} outside {tol} of float64 (max |Δ| {_err(a, b):.3e})")
    # The kernel forms its entries as the f32 kernel does (the distance by
    # the norm expansion, exact at coincident points; the SFU's exp), the
    # plain version by differences and torch's exp; the two round ~1e-3 of
    # the entries to neighbouring bf16 values, so the float64 product above
    # (of the plain formula's rounded tile) is as far from the kernel as
    # those flips make it.  The kernel's own product is held on row slices
    # to a float64 product of ITS rounded entries (bf16 B1 against the
    # identity): there at the state tolerance, and no further from it than
    # the plain version
    own = {}
    for lo in (0, 19_000, 38_000):
        rows = slice(lo, lo + 2000)
        Kb = kernel_entries_bf16(km, Xs[rows].contiguous(), Xs, "matern52", 1.0, 0.1, lo)
        v64 = Kb @ out[2][0].to(torch.bfloat16).double()
        own[lo] = {"kernel": _err(out[3][0, rows], v64), "plain": _err(ref[3][0, rows], v64)}
        check(_within(out[3][0, rows], v64, FUSED_STATE_TOL),
              f"{name}: V′ rows {lo}: outside {FUSED_STATE_TOL} of float64 of its own entries")
        check(own[lo]["kernel"] <= own[lo]["plain"],
              f"{name}: V′ rows {lo}: further from float64 of its entries than the plain version {own[lo]}")
        del Kb, v64
    witness["V_rows_vs_f64_of_own_entries"] = own
    again = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.0, 0.1,
                                  kernel_type="matern52", compute_dtype="bfloat16")
    check(all(torch.equal(a, b) for a, b in zip(out, again)), "bf16 B3: two runs differ")
    del out, ref, again, exact
    torch.cuda.empty_cache()
    emit({"phase": "fused_kernel_bf16", "cases": len(cases), "state_tol": FUSED_STATE_TOL,
          "V_and_red_tol_rel": BF16_REL_TOL, "state_max_abs_err": errs["B3_bf16"],
          "n40000_max_abs_err_U_R_D_V_red": witness,
          "max_V_rel_err": max(c.get("V_rel_err", 0.0) for c in cases),
          "max_red_rel_err": max(c.get("red_rel_err", 0.0) for c in cases)})


def phase_grad_kernel(km, rng, errs):
    """The gradient kernel against ``kernel_matmul_grad_plain`` (two
    launches, rows ≠ columns) and ``kernel_matmul_grad_sym_plain`` (one
    launch, one X), output by output (2e-4 relative: max |Δ| / max |plain|),
    and through X/ℓ to a scalar or ARD ℓ."""
    from repro_torch.kernels.kernel_matmul.ref import (
        kernel_matmul_grad_plain,
        kernel_matmul_grad_sym_plain,
    )

    dev = torch.device("cuda")
    d = 8
    cases = []

    def compare(name, out, ref, names=("X1", "X2", "outputscale", "sigma2", "lengthscale")):
        torch.cuda.synchronize()
        for a, b, nm in zip(out, ref, names):
            abs_err, rel = rel_err(a, b)
            errs["grad"] = max(errs["grad"], abs_err)
            cases.append({"case": f"{name} d/d{nm}", "max_abs_err": abs_err, "rel_err": rel})
            check(bool(torch.isfinite(a).all()), f"{name}: non-finite gradient for {nm}")
            check(rel <= REL_TOL, f"{name}: d/d{nm} relative error {rel:.3e} > {REL_TOL}")

    def with_lengthscale(X1, X2, ell, M, C, kt, off=0):
        """Both versions' gradients, and each carried through X/ℓ to ℓ."""
        ell = ell.clone().requires_grad_()
        Xs1, Xs2 = X1 / ell, X2 / ell
        outs = []
        for fn in (km.kernel_matmul_grad_cuda, kernel_matmul_grad_plain):
            g = fn(Xs1.detach(), Xs2.detach(), M, C, 1.1, 0.1, off, kernel_type=kt)
            (g_ell,) = torch.autograd.grad((Xs1, Xs2), ell, (g[0], g[1]), retain_graph=True)
            outs.append((*g, g_ell))
        return outs

    for rows, cols in ((1001, 1001), (1001, 2049)):
        for ard in (False, True):
            X1 = _randn(rng, (rows, d), dev)
            X2 = X1 if rows == cols else _randn(rng, (cols, d), dev)
            if rows != cols:
                X2[7] = X1[3]  # coincident points off the diagonal
            ell = (torch.from_numpy(rng.uniform(0.4, 1.5, d).astype("float32")).to(dev) if ard
                   else torch.tensor(0.7, device=dev))
            for t in (1, 9, 33):
                M, C = _randn(rng, (cols, t), dev), _randn(rng, (rows, t), dev)
                for kt in KERNEL_TYPES:
                    off = 0 if rows == cols else 5
                    ours, ref = with_lengthscale(X1, X2, ell, M, C, kt, off)
                    compare(f"grad {kt} rows={rows} cols={cols} t={t} ard={ard}", ours, ref)

    # one X on both sides (training): the one-launch symmetric VJP against
    # its plain twin and against the two-launch cross path, carried through
    # X/ℓ to ℓ; duplicated and near-coincident rows for Matérn-½
    SYM_NAMES = ("X", "outputscale", "sigma2", "lengthscale")

    def sym(X, ell, M, C, kt):
        ell = ell.clone().requires_grad_()
        Xs = X / ell
        outs = []
        for fn in (km.kernel_matmul_grad_sym_cuda, kernel_matmul_grad_sym_plain):
            before = km.grad_launches
            g = fn(Xs.detach(), M, C, 1.1, 0.1, kernel_type=kt)
            launched = km.grad_launches - before
            (g_ell,) = torch.autograd.grad(Xs, ell, g[0], retain_graph=True)
            outs.append((*g, g_ell, launched))
        return outs

    n = 1001
    X = _randn(rng, (n, d), dev)
    X[10] = X[3]
    X[20] = X[3] * (1 + 1e-3)
    ell = torch.from_numpy(rng.uniform(0.4, 1.5, d).astype("float32")).to(dev)
    for t in (1, 9, 33):
        M, C = _randn(rng, (n, t), dev), _randn(rng, (n, t), dev)
        for kt in KERNEL_TYPES:
            ours, ref = sym(X, ell, M, C, kt)
            check(ours[-1] == 1 + (2 * t - 1) // km.GRAD_MAX_K and ref[-1] == 0,
                  f"symmetric VJP t={t}: {ours[-1]} gradient launches")
            compare(f"grad sym {kt} n={n} t={t}", ours[:-1], ref[:-1], SYM_NAMES)
            two = km.kernel_matmul_grad_cuda(X / ell, X / ell, M, C, 1.1, 0.1, kernel_type=kt)
            compare(f"grad sym vs two launches {kt} n={n} t={t}",
                    ours[:3], (two[0] + two[1], two[2], two[3]), SYM_NAMES)

    # the slice's shape: one tensor on both sides, as in training, through
    # the symmetric VJP, and through the cross path
    n = 40_000
    Xs = torch.from_numpy((rng.uniform(-1, 1, (n, d)) / 0.5).astype("float32")).to(dev)
    M, C = _randn(rng, (n, 9), dev), _randn(rng, (n, 9), dev)
    ours = km.kernel_matmul_grad_sym_cuda(Xs, M, C, 1.0, 0.1, kernel_type="matern52")
    ref = kernel_matmul_grad_sym_plain(Xs, M, C, 1.0, 0.1, kernel_type="matern52")
    compare(f"grad sym matern52 n={n} t=9", ours, ref, SYM_NAMES)
    del ours, ref
    ours = km.kernel_matmul_grad_cuda(Xs, Xs, M, C, 1.0, 0.1, kernel_type="matern52")
    ref = kernel_matmul_grad_plain(Xs, Xs, M, C, 1.0, 0.1, kernel_type="matern52")
    compare(f"grad matern52 n={n} t=9", ours, ref)
    del ours, ref, Xs, M, C

    # the multitask MLL's backward: the symmetric VJP of the data kernel at
    # T·(1 + probes) = 36 columns over the n = 10,000 locations, one launch
    n = MT_N
    Xs = torch.from_numpy((rng.uniform(-1, 1, (n, d)) / 0.5).astype("float32")).to(dev)
    M, C = _randn(rng, (n, MT_WIDTH), dev), _randn(rng, (n, MT_WIDTH), dev)
    before = km.grad_launches
    ours = km.kernel_matmul_grad_sym_cuda(Xs, M, C, 1.0, 0.0, kernel_type="rbf")
    check(km.grad_launches - before == 1,
          f"multitask VJP: {km.grad_launches - before} gradient launches, 1 expected")
    ref = kernel_matmul_grad_sym_plain(Xs, M, C, 1.0, 0.0, kernel_type="rbf")
    compare(f"grad sym rbf multitask n={n} t={MT_WIDTH}", ours, ref, SYM_NAMES)
    del ours, ref, Xs, M, C
    torch.cuda.empty_cache()
    emit({"phase": "grad_kernel", "cases": len(cases), "tolerance_rel": REL_TOL,
          "largest_n": 40_000, "max_rel_err": max(c["rel_err"] for c in cases),
          "max_abs_err": errs["grad"]})


def library_yardstick(Xs, M, outputscale, sigma2, bf16=False):
    """torch.cdist → Matérn-5/2 map → torch.matmul: the library composition
    a user would write for (K + σ²I)·M; with ``bf16`` the matmul is one bf16
    torch.matmul of the rounded tile and M (its output bf16: a yardstick of
    time, not an oracle).  Timed here only."""
    a = math.sqrt(5.0) * torch.cdist(Xs, Xs)
    K = outputscale * (1.0 + a + a * a / 3.0) * torch.exp(-a)
    K.diagonal().add_(sigma2)
    if bf16:
        K, M = K.to(torch.bfloat16), M.to(torch.bfloat16)
    if M.dim() == 3:  # fold the batch into columns rather than copy K b times
        b, n, t = M.shape
        return (K @ M.permute(1, 0, 2).reshape(n, b * t)).reshape(n, b, t)
    return K @ M


def phase_timing(km, plain, rng, n, t_gram):
    dev = torch.device("cuda")
    d = 8
    X = rng.uniform(-1, 1, (n, d)).astype("float32")
    Xs = torch.from_numpy(X / 0.5).to(dev)
    rows = {}
    # t = 9: an mBCG iteration; t_gram: the cache's Gram product; t = 256:
    # each of predict's 256-point solve iterations; B2 at b = 4
    for label, t, batch in (("B1", 9, None), ("B1_gram", t_gram, None), ("B1_predict", 256, None),
                            ("B2", 9, 4)):
        shape = (n, t) if batch is None else (batch, n, t)
        M = torch.from_numpy(rng.standard_normal(shape).astype("float32")).to(dev)
        kern = lambda: km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.0, kernel_type="matern52")  # noqa: E731
        pl = lambda: plain(Xs, Xs, M, 1.0, 0.0, kernel_type="matern52")  # noqa: E731
        lib = lambda: library_yardstick(Xs, M, 1.0, 0.0)  # noqa: E731
        ms = time_ms(kern, reps=10)
        plain_ms = time_ms(pl, reps=3)
        library_ms = time_ms(lib, reps=3)
        bound_ms, bound_by, exps = kernel_bound(n, n, d, t, batch or 1)
        rows[label] = {
            "n": n, "d": d, "t": t, "batch": batch or 1, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "exps": exps,
            "bound_share": bound_ms / ms,
        }
        emit({"phase": "timing", "kernel": label, **rows[label]})
        del M
        torch.cuda.empty_cache()
    rows["B3"] = time_fused_step(km, rng, Xs, n, d)
    rows["grad"] = time_grad(km, rng, Xs, n, d)
    # bf16 B1/B2 and B3 (precision="mixed"): X/ℓ rounded to bf16 as the
    # mixed policy stores it, beside the f32 kernel's time from above
    Xb = Xs.to(torch.bfloat16).float()
    for label, f32_label, t, batch in (("B1_bf16", "B1", 9, None),
                                       ("B1_bf16_gram", "B1_gram", t_gram, None),
                                       ("B1_bf16_predict", "B1_predict", 256, None),
                                       ("B2_bf16", "B2", 9, 4)):
        shape = (n, t) if batch is None else (batch, n, t)
        M = torch.from_numpy(rng.standard_normal(shape).astype("float32")).to(dev)
        kern = lambda: km.kernel_matmul_cuda(Xb, Xb, M, 1.0, 0.0, kernel_type="matern52",  # noqa: E731
                                             compute_dtype="bfloat16")
        pl = lambda: plain(Xb, Xb, M, 1.0, 0.0, kernel_type="matern52",  # noqa: E731
                           compute_dtype="bfloat16")
        lib = lambda: library_yardstick(Xb, M, 1.0, 0.0, bf16=True)  # noqa: E731
        ms = time_ms(kern, reps=10)
        plain_ms = time_ms(pl, reps=1)
        library_ms = time_ms(lib, reps=3)
        bound_ms, bound_by, exps = kernel_bound(n, n, d, t, batch or 1, bf16=True)
        rows[label] = {
            "n": n, "d": d, "t": t, "batch": batch or 1, "ms": ms, "f32_kernel_ms": rows[f32_label]["ms"],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "exps": exps,
            "bound_share": bound_ms / ms,
        }
        emit({"phase": "timing", "kernel": label, **rows[label]})
        del M
        torch.cuda.empty_cache()
    rows["B3_bf16"] = time_fused_step(km, rng, Xb, n, d, bf16=True)
    rows["B3_bf16"]["f32_kernel_ms"] = rows["B3"]["ms"]
    return rows


def fused_library_yardstick(Xs, state, scalars, outputscale, sigma2, bf16=False):
    """The fused step composed of library calls: the torch state update,
    torch.cdist → Matérn-5/2 map → torch.matmul for K̂·D′ (a bf16 one with
    ``bf16``), the torch reductions.  Timed here only."""
    U, R, D, V = state
    a, b, g = (x[..., None, :] for x in scalars)
    U, R = U + a * D, R - a * V
    D = g * R + b * D
    V = library_yardstick(Xs, D[0], outputscale, sigma2, bf16=bf16)[None].float()
    return U, R, D, V, torch.stack([(D * V).sum(-2), (R * R).sum(-2), (R * V).sum(-2),
                                    (V * V).sum(-2)], dim=-2)


def grad_library_yardstick(Xs, M, C, outputscale, rows=8192):
    """Autograd through torch.cdist → Matérn-5/2 map → torch.matmul, the
    gradient for X (both sides) and the outputscale, a row slice at a time
    so that K's intermediates fit.  Timed here only."""
    X1 = Xs.detach().requires_grad_()
    s = torch.tensor(float(outputscale), device=Xs.device, requires_grad=True)
    for i in range(0, Xs.shape[0], rows):
        a = math.sqrt(5.0) * torch.cdist(X1[i : i + rows], X1)
        K = s * (1.0 + a + a * a / 3.0) * torch.exp(-a)
        (K @ M).backward(C[i : i + rows])
    return X1.grad, s.grad


def time_fused_step(km, rng, Xs, n, d, t=9, bf16=False):
    from repro_torch.kernels.kernel_matmul.ref import fused_cg_step_plain

    state, scalars = _cg_inputs(rng, Xs.device, 1, n, t)
    args = (Xs, Xs, *state, *state[1:], *scalars, 1.0, 0.1)
    cd = "bfloat16" if bf16 else "float32"
    ms = time_ms(lambda: km.fused_cg_step_cuda(*args, kernel_type="matern52", compute_dtype=cd),
                 reps=10)
    plain_ms = time_ms(lambda: fused_cg_step_plain(*args, kernel_type="matern52", compute_dtype=cd),
                       reps=1 if bf16 else 3)
    library_ms = time_ms(lambda: fused_library_yardstick(Xs, state, scalars, 1.0, 0.1, bf16=bf16),
                         reps=3)
    bound_ms, bound_by = fused_bound(n, d, t, bf16=bf16)
    row = {"n": n, "d": d, "t": t, "batch": 1, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / ms}
    emit({"phase": "timing", "kernel": "B3_bf16" if bf16 else "B3", **row})
    torch.cuda.empty_cache()
    return row


def time_grad(km, rng, Xs, n, d, t=9):
    """The symmetric VJP of training (one gradient-kernel launch with k = 2t
    and the σ² term) and its launch alone; the cross VJP (two launches with
    k = t) and one of its launches."""
    from repro_torch.kernels.kernel_matmul.ref import kernel_matmul_grad_sym_plain

    M, C = _randn(rng, (n, t), Xs.device), _randn(rng, (n, t), Xs.device)
    scal = torch.ones(1, device=Xs.device)
    A, B = torch.cat([C, M], dim=1), torch.cat([M, C], dim=1)
    ms = time_ms(lambda: km.kernel_matmul_grad_sym_cuda(Xs, M, C, 1.0, 0.1,
                                                        kernel_type="matern52"), reps=10)
    launch_ms = time_ms(lambda: km._grad_launch(Xs, Xs, A, B, scal, "matern52"), reps=10)
    cross_ms = time_ms(lambda: km.kernel_matmul_grad_cuda(Xs, Xs, M, C, 1.0, 0.1,
                                                          kernel_type="matern52"), reps=10)
    cross_launch_ms = time_ms(lambda: km._grad_launch(Xs, Xs, C, M, scal, "matern52"), reps=10)
    plain_ms = time_ms(lambda: kernel_matmul_grad_sym_plain(Xs, M, C, 1.0, 0.1,
                                                            kernel_type="matern52"), reps=1)
    library_ms = time_ms(lambda: grad_library_yardstick(Xs, M, C, 1.0), reps=1)
    bound_ms, bound_by = grad_bound(n, d, t)
    row = {"n": n, "d": d, "t": t, "batch": 1, "ms": ms, "ms_per_launch": launch_ms,
           "cross_vjp_ms": cross_ms, "cross_ms_per_launch": cross_launch_ms,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms}
    emit({"phase": "timing", "kernel": "grad", **row})
    torch.cuda.empty_cache()
    return row


def make_data(rng, n, d):
    """kin40k-shaped synthetic regression data (the gp_serve toy recipe)."""
    X = rng.uniform(-1, 1, (n, d)).astype("float32")
    y = (np.sin(3 * X[:, 0]) * np.cos(2 * X[:, -1])
         + 0.05 * rng.standard_normal(n)).astype("float32")
    return X, y


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _rms(a, b) -> float:
    return float((a.double() - b.double()).square().mean().sqrt())


def _within(a, b, tol) -> bool:
    return bool(((a - b).abs() <= tol["atol"] + tol["rtol"] * b.abs()).all())


def serve_once(gp, params, Xd, yd, qd, Pd):
    """One cache build, the cached requests and the uncached predict."""
    cache = gp.posterior_cache(params, Xd, yd)
    cached = [gp.predict_cached(params, Xd, cache, q) for q in qd]
    return cache, cached, gp.predict(params, Xd, yd, Pd)


def krylov_variance(gp, params, Xd, yd, cache, qd):
    """The cached variance on the cache build's Lanczos directions alone.

    The served cache orthonormalises [solves | Lanczos directions] by one
    QR.  The solves lie in the span of the directions, so that span is
    rank-deficient by the number of solves, and QR completes it with
    directions set by rounding; they move the served variance by ~1e-2
    between two paths that round differently.  This reruns the build's
    mBCG (same operator, preconditioner and probes), orthonormalises the
    directions without the solves and applies predict_cached's Rayleigh–Ritz
    formula.  Returns (variances, max |Δ alpha| of the rerun vs the build,
    singular values of the served span below 1e-6 of its largest)."""
    from repro_torch.core import mbcg

    s = gp.settings
    op = gp.operator(params, Xd).prepare()
    res = mbcg(op.matmul, torch.cat([yd[:, None], cache.probes], dim=-1),
               precond_solve=cache.precond.solve, max_iters=s.max_cg_iters,
               tol=s.cg_tol, return_basis=True)
    n = yd.shape[0]
    dirs = res.basis.reshape(n, -1)
    sv = torch.linalg.svdvals(torch.cat([res.solves, dirs], dim=-1))
    Q, _ = torch.linalg.qr(dirs)
    G = Q.T @ op.matmul(Q)
    G = 0.5 * (G + G.T)
    m = G.shape[0]
    eye = torch.eye(m, dtype=G.dtype, device=G.device)
    Lg = torch.linalg.cholesky(G + 1e-6 * torch.trace(G) / m * eye)
    kern, noise = gp.kernel(params), gp.noise(params)
    out = []
    for q in qd:
        v = Q.T @ kern(Xd, q)
        var = kern.diag(q) - torch.sum(v * torch.cholesky_solve(v, Lg), dim=0)
        out.append(torch.clamp(var, min=1e-8) + noise)
    return out, _err(res.solves[:, 0], cache.alpha), int((sv < 1e-6 * sv[0]).sum())


def f64_witness(gp, params, Xd, yd, qd, Pd, precond):
    """The port's plain path with the same hyperparameters and the same
    preconditioner, and the same mBCG trip count, in f64: what the served
    mean and predictive variance are without f32 rounding.  Also the
    relative distance of the kernel path's K̂⁻¹y from the f64 one for a
    sweep of trip counts: where f32 CG starts to part from f64 CG."""
    from repro_torch.core import AddedDiagOperator, PivotedCholeskyPreconditioner, solve
    from repro_torch.gp import KernelOperator, MaternKernel

    kern = gp.kernel(params)
    k64 = MaternKernel(lengthscale=kern.lengthscale.double(),
                       outputscale=kern.outputscale.double(), nu=2.5)
    noise = gp.noise(params).double()
    X64 = Xd.double()
    op = AddedDiagOperator(KernelOperator(kernel=k64, X=X64, mode="blocked", block_size=4096), noise)
    P = PivotedCholeskyPreconditioner.build(precond.L.double(), noise)
    alpha = solve(op, yd.double()[:, None], gp.settings, precond=P)[:, 0]
    means = [k64(X64, q.double()).T @ alpha for q in qd]
    Kxs = k64(X64, Pd.double())
    var = k64.diag(Pd.double()) - torch.sum(Kxs * solve(op, Kxs, gp.settings, precond=P), dim=0)
    onset = {}
    op32 = gp.operator(params, Xd)
    for p in (5, 8, 10, 12, 15, 20, gp.settings.max_cg_iters):
        s = dataclasses.replace(gp.settings, max_cg_iters=p)
        a32 = solve(op32, yd[:, None], s, precond=precond)[:, 0].double()
        a64 = solve(op, yd.double()[:, None], s, precond=P)[:, 0]
        onset[p] = float((a32 - a64).norm() / a64.norm())
    return means, (Kxs.T @ alpha, torch.clamp(var, min=1e-8) + noise), onset


def exact_posterior(X, y, queries, lengthscale, outputscale, noise, kernel="matern52"):
    """Exact Matérn-5/2 (or RBF) posterior mean and predictive variance by
    an f64 Cholesky of K̂ on the card, for each query block."""
    n = X.shape[0]
    Xs = X.double() / lengthscale

    def k(A, B):
        r = torch.cdist(A, B, compute_mode="donot_use_mm_for_euclid_dist")
        if kernel == "rbf":
            return outputscale * torch.exp(-0.5 * r * r)
        a = math.sqrt(5.0) * r
        return outputscale * (1.0 + a + a * a / 3.0) * torch.exp(-a)

    K = torch.empty((n, n), dtype=torch.float64, device=X.device)
    for i in range(0, n, 4096):
        K[i : i + 4096] = k(Xs[i : i + 4096], Xs)
    K.diagonal().add_(noise)
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y.double()[:, None], L)[:, 0]
    out = []
    for Q in queries:
        Kxs = k(Xs, Q.double() / lengthscale)
        var = outputscale - (Kxs * torch.cholesky_solve(Kxs, L)).sum(0) + noise
        out.append((Kxs.T @ alpha, var))
    del L
    torch.cuda.empty_cache()
    return out


def phase_serve(km, rng, n):
    from repro_torch import ExactGP, params_from_jax
    from repro_torch.core import BBMMSettings, health

    d = 8
    settings = BBMMSettings(num_probes=8, max_cg_iters=25, precond_rank=5)
    X, y = make_data(rng, n, d)
    queries = [rng.uniform(-1, 1, (1024, d)).astype("float32") for _ in range(8)]
    Xpred = rng.uniform(-1, 1, (256, d)).astype("float32")
    raw = {
        "raw_lengthscale": np.float32(inv_softplus(0.5)),
        "raw_outputscale": np.float32(inv_softplus(1.0)),
        "raw_noise": np.float32(inv_softplus(0.1)),
    }
    params = params_from_jax(raw, device="cuda")
    Xd, yd = torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()
    qd = [torch.from_numpy(q).cuda() for q in queries]
    Pd = torch.from_numpy(Xpred).cuda()

    gp = ExactGP(kernel_type="matern52", mode="cuda", settings=settings)
    # launches per phase of the main path, counted from 0 just before each
    counts = {}
    km.reset_launch_counts()
    with health.collect() as build_reports:
        cache, build_ms, build_dev_ms = timed(lambda: gp.posterior_cache(params, Xd, yd))
    counts["build"] = (km.launches, km.batched_launches)
    km.reset_launch_counts()
    cached, req_ms, req_dev_ms = [], [], []
    for q in qd:
        out, host_ms, dev_ms = timed(lambda: gp.predict_cached(params, Xd, cache, q))
        cached.append(out)
        req_ms.append(host_ms)
        req_dev_ms.append(dev_ms)
    counts["requests"] = (km.launches, km.batched_launches)
    km.reset_launch_counts()
    with health.collect() as predict_reports:
        (pmean, pvar), predict_ms, predict_dev_ms = timed(
            lambda: gp.predict(params, Xd, yd, Pd)
        )
    counts["predict"] = (km.launches, km.batched_launches)
    main_launches = sum(c[0] for c in counts.values())
    main_batched = sum(c[1] for c in counts.values())
    # the build above was the process's first, so it paid the CUDA solver
    # libraries' first use: time three more builds warm
    warm_build_ms = [timed(lambda: gp.posterior_cache(params, Xd, yd))[1] for _ in range(3)]

    p = settings.max_cg_iters
    check(counts["build"][0] == p + 1,
          f"B1 launches in one cache build {counts['build'][0]} != max_cg_iters + 1 = {p + 1}")
    check(counts["requests"][0] == 0, f"predict_cached launched B1 {counts['requests'][0]} times")
    check(counts["predict"][0] == 2 * p,
          f"B1 launches in predict {counts['predict'][0]} != 2 * max_cg_iters = {2 * p}")
    for mean, var in cached:
        check(mean.shape == (1024,) and var.shape == (1024,), "cached output shape")
        check(bool(torch.isfinite(mean).all() & torch.isfinite(var).all()), "non-finite cached output")
        check(bool((var > 0).all()), "non-positive cached variance")
    check(pmean.shape == (256,) and bool(torch.isfinite(pmean).all() & torch.isfinite(pvar).all()),
          "uncached predict output")
    reports = build_reports + predict_reports
    check(len(build_reports) == 1 and len(predict_reports) == 2,
          f"health reports: {len(build_reports)} build, {len(predict_reports)} predict")
    emit({
        "phase": "serve", "path": "cuda", "n": n, "d": d, "kernel": "matern52",
        "settings": {"num_probes": 8, "max_cg_iters": p, "precond_rank": 5},
        "build_ms": build_ms, "build_device_ms": build_dev_ms,
        "build_warm_ms": warm_build_ms,
        "request_ms": req_ms, "request_device_ms": req_dev_ms,
        "request_ms_mean": sum(req_ms) / len(req_ms),
        "predict_256_ms": predict_ms, "predict_256_device_ms": predict_dev_ms,
        "launches": {k: v[0] for k, v in counts.items()},
        "health": [{"context": r.context, "status": r.status,
                    "residual_norm": r.residual_norm, "num_iters": r.num_iters}
                   for r in reports],
        "basis_columns": int(cache.basis.shape[1]),
        "logdet": float(cache.logdet), "inv_quad": float(cache.inv_quad),
    })

    data = (params, Xd, yd, qd, Pd)
    phase_prefix(km, settings, data)
    exact = phase_witness(km, gp, settings, data, cache, cached + [(pmean, pvar)])
    highest = {"cached_means": [o[0] for o in cached], "predict_mean": pmean,
               "exact": exact,
               "build_warm_ms": warm_build_ms, "predict_ms": predict_ms}
    return main_launches, main_batched, build_ms, req_ms, data, highest


def phase_prefix(km, settings, data):
    """The slice with the CG trip count cut to PREFIX_ITERS, on the kernel
    path and on the plain path, held to each other at the slice tolerances.
    Over the first iterations f32 CG on this problem tracks f64 CG to ~1e-6,
    so a difference here is a fault, not rounding."""
    from repro_torch import ExactGP

    params, Xd, yd, qd, Pd = data
    s = dataclasses.replace(settings, max_cg_iters=PREFIX_ITERS)
    runs = {}
    for mode in ("cuda", "dense"):
        gp = ExactGP(kernel_type="matern52", mode=mode, settings=s)
        km.reset_launch_counts()
        cache, cached, predicted = serve_once(gp, params, Xd, yd, qd, Pd)
        launches = km.launches
        kvar, rerun_err, deficient = krylov_variance(gp, params, Xd, yd, cache, qd)
        check(rerun_err <= MEAN_TOL["atol"], f"{mode}: rerun of the build's mBCG is off by {rerun_err:.3e}")
        runs[mode] = dict(cache=cache, cached=cached, predicted=predicted, kvar=kvar,
                          launches=launches, deficient=deficient)
    k, p = runs["cuda"], runs["dense"]
    check(k["launches"] == 3 * PREFIX_ITERS + 1 and p["launches"] == 0,
          f"prefix launches: cuda {k['launches']} != 3 * {PREFIX_ITERS} + 1, plain {p['launches']}")

    pairs = {
        "cached_mean": ([o[0] for o in k["cached"]], [o[0] for o in p["cached"]], MEAN_TOL),
        "cached_var_krylov": (k["kvar"], p["kvar"], VAR_TOL),
        "predict_mean": ([k["predicted"][0]], [p["predicted"][0]], MEAN_TOL),
        "predict_var": ([k["predicted"][1]], [p["predicted"][1]], VAR_TOL),
        "inv_quad": ([k["cache"].inv_quad], [p["cache"].inv_quad], MEAN_TOL),
        "logdet": ([k["cache"].logdet], [p["cache"].logdet], MEAN_TOL),
    }
    stats = {}
    for name, (ours, plain, tol) in pairs.items():
        within = all(_within(a, b, tol) for a, b in zip(ours, plain))
        stats[name] = {"cuda_vs_plain": max(_err(a, b) for a, b in zip(ours, plain)),
                       "within_slice_tol": within}
    served = ([o[1] for o in k["cached"]], [o[1] for o in p["cached"]])
    stats["cached_var_served"] = {
        "cuda_vs_plain": max(_err(a, b) for a, b in zip(*served)),
        "within_slice_tol": all(_within(a, b, VAR_TOL) for a, b in zip(*served)),
        "served_vs_krylov": {m: max(_err(a[1], b) for a, b in zip(r["cached"], r["kvar"]))
                             for m, r in runs.items()},
        "span_rank_deficit": {m: r["deficient"] for m, r in runs.items()},
    }
    emit({"phase": "serve_prefix", "max_cg_iters": PREFIX_ITERS, "mean_tol": MEAN_TOL,
          "var_tol": VAR_TOL, "launches": {m: r["launches"] for m, r in runs.items()},
          "health": {m: r["cache"].cg_iters.tolist() for m, r in runs.items()}, **stats})
    for name in pairs:
        check(stats[name]["within_slice_tol"],
              f"prefix {name}: cuda vs plain {stats[name]['cuda_vs_plain']:.3e} outside the slice tolerance")


def phase_witness(km, gp, settings, data, cache, ours):
    """The full-trip-count outputs of the kernel path beside the plain path
    (K formed), the same mBCG in f64, and the exact f64 posterior.  After
    ~10 iterations f32 CG on this problem loses orthogonality and two
    correct f32 paths part ways by about their distance from the answer,
    so the kernel path is held to what holds whatever the rounding: finite
    outputs and a cached variance that is conservative against the exact
    one.  The distances are reported, with λ_max(K̂)/σ², an estimate of
    K̂'s condition number."""
    from repro_torch import ExactGP

    params, Xd, yd, qd, Pd = data
    gp_plain = ExactGP(kernel_type="matern52", mode="dense", settings=settings)
    km.reset_launch_counts()
    (cache_p, cached_p, predicted_p), plain_ms, _ = timed(
        lambda: serve_once(gp_plain, params, Xd, yd, qd, Pd)
    )
    check(km.launches == 0 and km.batched_launches == 0, "the plain path launched the kernel")
    w_means, w_predicted, onset = f64_witness(gp, params, Xd, yd, qd, Pd, cache.precond)
    # λ_max(K̂) by power iteration through the kernel; λ_min(K̂) ≥ σ²
    op = gp.operator(params, Xd).prepare()
    v = torch.ones_like(yd) / math.sqrt(yd.shape[0])
    for _ in range(30):
        w = op.matmul(v)
        lam_max = float(torch.dot(v, w))
        v = w / torch.linalg.vector_norm(w)
    kern = gp.kernel(params)
    exact = exact_posterior(Xd, yd, qd + [Pd], float(kern.lengthscale),
                            float(kern.outputscale), float(gp.noise(params)))
    paths = {"cuda": ours, "plain": cached_p + [predicted_p],
             "f64": [(m, None) for m in w_means] + [w_predicted]}
    stats = {}
    for label, sl in (("cached", slice(0, 8)), ("predict", slice(8, 9))):
        for key, idx in (("mean", 0), ("var", 1)):
            names = [m for m, outs in paths.items() if outs[sl][0][idx] is not None]
            row = {}
            for i, a in enumerate(names):
                for b in names[i + 1:] + ["exact"]:
                    other = exact if b == "exact" else paths[b]
                    row[f"{a}_vs_{b}"] = max(_err(o[idx], e[idx])
                                             for o, e in zip(paths[a][sl], other[sl]))
            stats[f"{label}_{key}"] = row
    under = max(float((e[1] - o[1]).max()) for o, e in zip(ours[:8], exact[:8]))
    emit({"phase": "serve_witness", "max_cg_iters": settings.max_cg_iters,
          "plain_serve_ms": plain_ms,
          "precond_L_cuda_vs_plain": _err(cache.precond.L, cache_p.precond.L),
          "lambda_max": lam_max, "cond_estimate": lam_max / float(gp.noise(params)),
          "max_abs_err": stats, "alpha_cuda_vs_f64_rel_by_iters": onset,
          "cached_var_max_undershoot": under})
    check(under <= 1e-3, f"cached variance undershoots the exact one by {under:.3e}")
    return exact


@contextlib.contextmanager
def plain_kernels(km):
    """Every kernel wrapper of the GP path replaced by its plain version (K
    formed, autograd for the gradient): B1's and the gradient kernel's (both
    VJPs) in the kernel module, and B1's, B3's and the panel VJP's gradient
    call as ``ops`` binds them (the bf16 product, the fused step, the panel
    streams), each in the dtype asked for — so the path runs without any
    kernel: nothing launches inside."""
    from repro_torch.kernels.kernel_matmul import ops, ref

    saved = km.kernel_matmul_cuda, km.kernel_matmul_grad_cuda, km.kernel_matmul_grad_sym_cuda
    saved_ops = ops.kernel_matmul_cuda, ops.fused_cg_step_cuda, ops.kernel_matmul_grad_rows_cuda

    def grad_plain(*args, need_cols=True, **kw):
        return ref.kernel_matmul_grad_plain(*args, **kw)

    def grad_rows_plain(X1, X2, A, B, outputscale, *, kernel_type):
        gX1, _, gs, _ = ref.kernel_matmul_grad_plain(X1, X2, B, A, outputscale, 0.0,
                                                     kernel_type=kernel_type)
        return gX1, gs

    km.kernel_matmul_cuda = ops.kernel_matmul_cuda = ref.kernel_matmul_plain
    ops.fused_cg_step_cuda = ref.fused_cg_step_plain
    ops.kernel_matmul_grad_rows_cuda = grad_rows_plain
    km.kernel_matmul_grad_cuda = grad_plain
    km.kernel_matmul_grad_sym_cuda = ref.kernel_matmul_grad_sym_plain
    try:
        yield
    finally:
        km.kernel_matmul_cuda, km.kernel_matmul_grad_cuda, km.kernel_matmul_grad_sym_cuda = saved
        ops.kernel_matmul_cuda, ops.fused_cg_step_cuda, ops.kernel_matmul_grad_rows_cuda = saved_ops


def _counts(km):
    return {"B3": km.fused_launches, "B1": km.launches, "grad": km.grad_launches}


def phase_train(km, seed, n):
    """The training slice: ExactGP(mode="cuda", fuse_cg=True,
    precond_rank=0).fit for TRAIN_STEPS Adam steps on the serving data,
    then the checks described in the module docstring.  Returns the
    launches of the slice's runs."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings

    d = 8
    X, y = make_data(np.random.default_rng(seed), n, d)
    Xd, yd = torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()
    settings = BBMMSettings(num_probes=8, max_cg_iters=25, precond_rank=0)
    p = settings.max_cg_iters
    gp = ExactGP(kernel_type="matern52", mode="cuda", fuse_cg=True, settings=settings)

    # the main path: fit, each step synchronised, timed and counted
    steps = []
    clock = [0.0]

    def on_step(i, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append({"step": i, "loss": loss, "ms": (now - clock[0]) * 1e3, **_counts(km)})
        km.reset_launch_counts()
        clock[0] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.reset_launch_counts()
    clock[0] = time.perf_counter()
    params, history = gp.fit(Xd, yd, steps=TRAIN_STEPS, callback=on_step)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: sum(st[k] for st in steps) for k in ("B3", "B1", "grad")}
    emit({"phase": "train", "path": "cuda fused", "n": n, "d": d, "kernel": "matern52",
          "settings": {"num_probes": 8, "max_cg_iters": p, "precond_rank": 0, "fuse_cg": True},
          "lr": 0.1, "steps": steps, "loss_history": history,
          "step_ms_mean": sum(st["ms"] for st in steps) / len(steps),
          "grad_launches_per_step": [st["grad"] for st in steps],
          "peak_device_bytes": peak, "dense_K_bytes": 4 * n * n,
          "params": {k: v.tolist() for k, v in params.items()}})
    check(len(history) == TRAIN_STEPS and all(math.isfinite(v) for v in history),
          f"non-finite loss history {history}")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()), "non-finite parameters")
    for st in steps:
        check(st["B3"] == p and st["grad"] == 1 and st["B1"] == 1,
              f"step {st['step']}: launches {st} != B3 {p}, B1 1 (the VJP's primal), grad 1")
    check(peak < 4 * n * n / 4, f"peak device memory {peak} B: a quarter of K is 1.6 GB")

    # the anatomy of one step: B3 only in the forward, the VJP in the backward
    p0 = {k: v.clone().requires_grad_() for k, v in gp.init_params(Xd).items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    km.reset_launch_counts()
    loss = gp.loss(p0, Xd, yd, gen)
    forward = _counts(km)
    km.reset_launch_counts()
    loss.backward()
    torch.cuda.synchronize()
    backward = _counts(km)
    emit({"phase": "train_step_anatomy", "forward": forward, "backward": backward,
          "device_ms_by_kernel": profile_step(gp, Xd, yd)})
    check(forward == {"B3": p, "B1": 0, "grad": 0}, f"fused forward launches {forward}")
    check(backward == {"B3": 0, "B1": 1, "grad": 1}, f"backward launches {backward}")
    main = dict(launches)

    phase_train_prefix(km, gp, settings, Xd, yd)

    # one unfused step at the default preconditioner: B1 forward, same VJP
    s5 = dataclasses.replace(settings, precond_rank=5)
    gp5 = ExactGP(kernel_type="matern52", mode="cuda", settings=s5)
    km.reset_launch_counts()
    (params5, hist5), ms5, _ = timed(lambda: gp5.fit(Xd, yd, steps=1))
    unfused = _counts(km)
    emit({"phase": "train_unfused", "settings": {"num_probes": 8, "max_cg_iters": p,
                                                   "precond_rank": 5, "fuse_cg": False},
          "step_ms": ms5, "loss": hist5, "launches": unfused})
    check(unfused == {"B3": 0, "B1": p + 1, "grad": 1}, f"unfused step launches {unfused}")
    check(all(math.isfinite(v) for v in hist5), "unfused step: non-finite loss")
    for k in main:
        main[k] += unfused[k]
    return main, history, steps


def profile_step(gp, Xd, yd, top=6, data=None):
    """Device time of one warm training step (loss and backward) by kernel,
    from torch.profiler: the largest ``top`` entries, the rest summed, the
    step's wall time and the device's busy time in all (``data``: the
    model's prepared inputs, X itself by default)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.gp.training import tree_map

    p0 = tree_map(lambda v: v.clone().requires_grad_(), gp.init_params(Xd))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gp.loss(p0, Xd if data is None else data, yd, gen).backward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda kv: -kv[1],
    )
    out = {name[:60]: ms for name, ms in kernels[:top]}
    out["other"] = sum(ms for _, ms in kernels[top:])
    out["step_wall_ms_profiled"] = wall
    out["device_busy_ms"] = sum(ms for _, ms in kernels)
    return out


def phase_train_prefix(km, gp, settings, Xd, yd):
    """The first step cut to PREFIX_ITERS CG iterations, with the same
    probes on every path: the fused kernel path against the unfused path
    with every kernel replaced by its plain version (loss and each
    parameter's gradient), and the fused B3 solves against the unfused B1
    solves."""
    from repro_torch import ExactGP
    from repro_torch.core import engine_state

    s = dataclasses.replace(settings, max_cg_iters=PREFIX_ITERS)
    fused = ExactGP(kernel_type="matern52", mode="cuda", fuse_cg=True, settings=s)
    unfused = ExactGP(kernel_type="matern52", mode="cuda", settings=s)
    p0 = gp.init_params(Xd)

    def generator():
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        return g

    def loss_and_grads(model):
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        loss = model.loss(p, Xd, yd, generator())
        loss.backward()
        return loss.detach(), {k: v.grad for k, v in p.items()}

    lf, gf = loss_and_grads(fused)
    with plain_kernels(km):
        km.reset_launch_counts()
        lp, gp_ = loss_and_grads(unfused)
        plain_launches = _counts(km)
    sf = engine_state(fused.operator(p0, Xd), yd, generator(), fused.settings)
    su = engine_state(unfused.operator(p0, Xd), yd, generator(), unfused.settings)
    grads = {k: {"fused_kernel": gf[k].tolist(), "unfused_plain": gp_[k].tolist(),
                 "rel_err": float((gf[k] - gp_[k]).abs().max() / gp_[k].abs().max())}
             for k in gf}
    solves = {"solve_y": _err(sf.solve_y, su.solve_y),
              "probe_solves": _err(sf.probe_solves, su.probe_solves)}
    emit({"phase": "train_prefix", "max_cg_iters": PREFIX_ITERS,
          "loss": {"fused_kernel": float(lf), "unfused_plain": float(lp)},
          "loss_rel_err": abs(float(lf - lp)) / abs(float(lp)), "mll_rtol": MLL_RTOL,
          "grads": grads, "grad_rtol": GRAD_RTOL, "solves_fused_vs_b1_max_abs": solves,
          "solve_tol": SOLVE_TOL, "plain_launches": plain_launches})
    check(sum(plain_launches.values()) == 0, "the plain path launched a kernel")
    check(abs(float(lf - lp)) <= MLL_RTOL * abs(float(lp)),
          f"prefix MLL: fused kernel {float(lf)} vs unfused plain {float(lp)}")
    for k, g in grads.items():
        check(g["rel_err"] <= GRAD_RTOL, f"prefix gradient {k}: relative error {g['rel_err']:.3e}")
    check(_within(sf.solve_y, su.solve_y, SOLVE_TOL) and _within(sf.probe_solves, su.probe_solves, SOLVE_TOL),
          f"prefix solves: fused B3 vs unfused B1 {solves}")


def _dtype_counts(km):
    """Launches since the last reset by kernel and dtype."""
    return {"B1_bf16": km.bf16_launches, "B1": km.launches, "B2_bf16": km.bf16_batched_launches,
            "B2": km.batched_launches, "B3_bf16": km.bf16_fused_launches, "B3": km.fused_launches,
            "grad": km.grad_launches}


def _rel_norm(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def phase_serve_mixed(km, data, highest):
    """The serving slice at precision="mixed": ExactGP(matern52, mode="cuda",
    precision="mixed") on the serving data — one cache build (timed cold and
    warm), the eight cached requests, the 256-point predict, peak memory and
    the launches by dtype: bf16 B1 once per CG iteration, f32 B1 once per
    refresh (the static period 2: ⌊p/2⌋ in the loop and one final) and for
    the cache's Gram product; nothing else.  The served means against
    "highest" (phase serve) within MIXED_MEAN_REL; then the slice cut to
    PREFIX_ITERS iterations against itself with every kernel replaced by its
    bf16 plain version, at MIXED_PREFIX_TOL."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings, health

    params, Xd, yd, qd, Pd = data
    settings = BBMMSettings(num_probes=8, max_cg_iters=25, precond_rank=5)
    p = settings.max_cg_iters
    refreshes = p // settings.cg_refresh_every
    gp = ExactGP(kernel_type="matern52", mode="cuda", settings=settings, precision="mixed")
    counts = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.reset_launch_counts()
    with health.collect() as build_reports:
        cache, build_ms, build_dev_ms = timed(lambda: gp.posterior_cache(params, Xd, yd))
    counts["build"] = _dtype_counts(km)
    km.reset_launch_counts()
    cached, req_ms = [], []
    for q in qd:
        out, host_ms, _ = timed(lambda: gp.predict_cached(params, Xd, cache, q))
        cached.append(out)
        req_ms.append(host_ms)
    counts["requests"] = _dtype_counts(km)
    km.reset_launch_counts()
    with health.collect() as predict_reports:
        (pmean, pvar), predict_ms, predict_dev_ms = timed(lambda: gp.predict(params, Xd, yd, Pd))
    counts["predict"] = _dtype_counts(km)
    peak = torch.cuda.max_memory_allocated()
    warm_build_ms = [timed(lambda: gp.posterior_cache(params, Xd, yd))[1] for _ in range(3)]
    warm_predict_ms = timed(lambda: gp.predict(params, Xd, yd, Pd))[1]

    zero = {k: 0 for k in counts["build"]}
    want = {"build": {**zero, "B1_bf16": p, "B1": refreshes + 2},
            "requests": zero,
            "predict": {**zero, "B1_bf16": 2 * p, "B1": 2 * (refreshes + 1)}}
    reports = build_reports + predict_reports
    # at 25 iterations CG on this problem (κ ≈ 3,900) has not converged in
    # either precision: two correct f32 paths part by about their distance
    # from the answer (phase serve_witness).  So the full-depth means are
    # reported against "highest" and against the exact posterior, and held
    # to "highest" at MIXED_MEAN_REL over the prefix (phase_serve_mixed_prefix)
    exact = highest["exact"]
    served = [o[0] for o in cached] + [pmean]
    means = {"cached_vs_highest": max(_rel_norm(o[0], h) for o, h in zip(cached, highest["cached_means"])),
             "predict_vs_highest": _rel_norm(pmean, highest["predict_mean"]),
             "mixed_vs_exact": max(_rel_norm(m, e[0]) for m, e in zip(served, exact)),
             "highest_vs_exact": max(_rel_norm(m, e[0]) for m, e in
                                     zip(highest["cached_means"] + [highest["predict_mean"]], exact))}
    under = max(float((e[1] - o[1]).max()) for o, e in zip(cached, exact[:8]))
    emit({"phase": "serve_mixed", "path": "cuda", "precision": "mixed", "n": Xd.shape[0],
          "settings": {"num_probes": 8, "max_cg_iters": p, "precond_rank": 5,
                       "cg_refresh_every": settings.cg_refresh_every},
          "build_ms": build_ms, "build_device_ms": build_dev_ms, "build_warm_ms": warm_build_ms,
          "highest_build_warm_ms": highest["build_warm_ms"],
          "request_ms": req_ms, "predict_256_ms": predict_ms, "predict_256_device_ms": predict_dev_ms,
          "predict_256_warm_ms": warm_predict_ms, "highest_predict_256_ms": highest["predict_ms"],
          "peak_device_bytes": peak, "launches": counts,
          "health": [{"context": r.context, "status": r.status, "residual_norm": r.residual_norm,
                      "num_refreshes": r.num_refreshes, "num_curvature_skips": r.num_curvature_skips,
                      "num_rescues": r.num_rescues} for r in reports],
          "mean_rel": means, "cached_var_max_undershoot": under})
    for phase, got in counts.items():
        check(got == want[phase], f"mixed {phase} launches {got} != {want[phase]}")
    check(all(r.num_refreshes == refreshes for r in reports),
          f"refreshes {[r.num_refreshes for r in reports]} != ⌊{p}/2⌋ = {refreshes}")
    for mean, var in cached + [(pmean, pvar)]:
        check(bool(torch.isfinite(mean).all() & torch.isfinite(var).all() & (var > 0).all()),
              "mixed serving: non-finite output or non-positive variance")
    check(under <= 1e-3, f"mixed cached variance undershoots the exact one by {under:.3e}")
    phase_serve_mixed_prefix(km, data)
    launches = {k: sum(c[k] for c in counts.values()) for k in zero}
    return launches, {"build_ms": build_ms, "build_warm_ms": warm_build_ms,
                      "predict_ms": predict_ms, "predict_warm_ms": warm_predict_ms}


def phase_serve_mixed_prefix(km, data):
    """The mixed serving slice cut to PREFIX_ITERS CG iterations, where two
    correct paths still agree: on the kernel path against the same path with
    every kernel replaced by its bf16 (and, for the refreshes, f32) plain
    version — served means, predictive variance, inv_quad and logdet within
    MIXED_PREFIX_TOL — and against "highest", the served means within
    MIXED_MEAN_REL."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings

    params, Xd, yd, qd, Pd = data
    s = BBMMSettings(num_probes=8, max_cg_iters=PREFIX_ITERS, precond_rank=5)
    gp = ExactGP(kernel_type="matern52", mode="cuda", settings=s, precision="mixed")
    km.reset_launch_counts()
    ours = serve_once(gp, params, Xd, yd, qd[:2], Pd)
    kernel_launches = _dtype_counts(km)
    high = serve_once(dataclasses.replace(gp, precision="highest"), params, Xd, yd, qd[:2], Pd)
    vs_highest = {"cached_mean": max(_rel_norm(a[0], b[0]) for a, b in zip(ours[1], high[1])),
                  "predict_mean": _rel_norm(ours[2][0], high[2][0])}
    with plain_kernels(km):
        km.reset_launch_counts()
        plain = serve_once(gp, params, Xd, yd, qd[:2], Pd)
        plain_launches = _dtype_counts(km)
    pairs = {"cached_mean": ([o[0] for o in ours[1]], [o[0] for o in plain[1]]),
             "predict_mean": ([ours[2][0]], [plain[2][0]]),
             "predict_var": ([ours[2][1]], [plain[2][1]]),
             "inv_quad": ([ours[0].inv_quad], [plain[0].inv_quad]),
             "logdet": ([ours[0].logdet], [plain[0].logdet])}
    stats = {k: max(_err(a, b) for a, b in zip(*v)) for k, v in pairs.items()}
    emit({"phase": "serve_mixed_prefix", "max_cg_iters": PREFIX_ITERS, "tol": MIXED_PREFIX_TOL,
          "kernel_vs_plain_max_abs": stats, "kernel_launches": kernel_launches,
          "plain_launches": plain_launches, "mean_rel_vs_highest": vs_highest,
          "mean_tol_vs_highest": MIXED_MEAN_REL})
    check(sum(plain_launches.values()) == 0, "the plain mixed path launched a kernel")
    check(max(vs_highest.values()) <= MIXED_MEAN_REL, f"mixed prefix means vs highest {vs_highest}")
    check(kernel_launches["B1_bf16"] > 0, "the mixed kernel path launched no bf16 B1")
    for k, (a, b) in pairs.items():
        check(all(_within(x, y, MIXED_PREFIX_TOL) for x, y in zip(a, b)),
              f"mixed prefix {k}: kernel vs plain {stats[k]:.3e} outside {MIXED_PREFIX_TOL}")


def phase_train_mixed(km, seed, n, highest_history):
    """The training slice at precision="mixed": ExactGP(matern52,
    mode="cuda", fuse_cg=True, precond_rank=0, precision="mixed").fit for
    TRAIN_STEPS steps, each synchronised, timed and counted: bf16 B3 once
    per CG iteration, f32 B1 once per refresh (⌊p/2⌋ + one final) and once
    for the backward's primal, one gradient launch (f32: the backward runs
    through the f32 operator); the MLL against "highest" (phase train, same
    parameters and probes) reported (at 25 iterations neither precision's
    solve has converged here); peak memory; a profiled step; a PREFIX_ITERS
    prefix against the same path with every kernel replaced by its plain
    version and against "highest" (MIXED_MLL_PER_POINT per data point); one
    unfused mixed step at precond_rank=5."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings

    d = 8
    X, y = make_data(np.random.default_rng(seed), n, d)
    Xd, yd = torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()
    settings = BBMMSettings(num_probes=8, max_cg_iters=25, precond_rank=0)
    p = settings.max_cg_iters
    refreshes = p // settings.cg_refresh_every
    gp = ExactGP(kernel_type="matern52", mode="cuda", fuse_cg=True, settings=settings,
                 precision="mixed")
    steps = []
    clock = [0.0]

    def on_step(i, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append({"step": i, "loss": loss, "ms": (now - clock[0]) * 1e3, **_dtype_counts(km)})
        km.reset_launch_counts()
        clock[0] = time.perf_counter()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.reset_launch_counts()
    clock[0] = time.perf_counter()
    params, history = gp.fit(Xd, yd, steps=TRAIN_STEPS, callback=on_step)
    peak = torch.cuda.max_memory_allocated()
    mll_gap = abs(history[0] - highest_history[0]) / n
    profile = profile_step(gp, Xd, yd)
    emit({"phase": "train_mixed", "path": "cuda fused", "precision": "mixed", "n": n,
          "settings": {"num_probes": 8, "max_cg_iters": p, "precond_rank": 0, "fuse_cg": True,
                       "cg_refresh_every": settings.cg_refresh_every},
          "steps": steps, "loss_history": history, "highest_loss_history": highest_history,
          "step_ms_mean_warm": sum(st["ms"] for st in steps[1:]) / (len(steps) - 1),
          "mll_per_point_vs_highest": mll_gap,
          "peak_device_bytes": peak, "device_ms_by_kernel": profile})
    check(len(history) == TRAIN_STEPS and all(math.isfinite(v) for v in history),
          f"mixed training: non-finite loss history {history}")
    zero = {k: 0 for k in _dtype_counts(km)}
    want = {**zero, "B3_bf16": p, "B1": refreshes + 2, "grad": 1}
    for st in steps:
        got = {k: st[k] for k in zero}
        check(got == want, f"mixed step {st['step']}: launches {got} != {want}")
    launches = {k: sum(st[k] for st in steps) for k in zero}

    phase_train_mixed_prefix(km, gp, Xd, yd)

    s5 = dataclasses.replace(settings, precond_rank=5)
    gp5 = ExactGP(kernel_type="matern52", mode="cuda", settings=s5, precision="mixed")
    km.reset_launch_counts()
    (_, hist5), ms5, _ = timed(lambda: gp5.fit(Xd, yd, steps=1))
    unfused = _dtype_counts(km)
    emit({"phase": "train_mixed_unfused", "step_ms": ms5, "loss": hist5, "launches": unfused})
    check(unfused == {**zero, "B1_bf16": p, "B1": refreshes + 2, "grad": 1},
          f"mixed unfused step launches {unfused}")
    check(all(math.isfinite(v) for v in hist5), "mixed unfused step: non-finite loss")
    for k in launches:
        launches[k] += unfused[k]
    return launches, steps


def phase_train_mixed_prefix(km, gp, Xd, yd):
    """The first mixed step cut to PREFIX_ITERS CG iterations, the same
    probes on every path: the fused kernel path against the same path with
    every kernel replaced by its plain version (bf16 for the loop, f32 for
    the refreshes and the backward) — the loss within MIXED_PREFIX_TOL's
    rtol, each parameter's gradient within MIXED_GRAD_RTOL of its size —
    and against the same step at "highest", the MLL within
    MIXED_MLL_PER_POINT per data point."""
    s = dataclasses.replace(gp.settings, max_cg_iters=PREFIX_ITERS)
    model = dataclasses.replace(gp, settings=s)
    p0 = model.init_params(Xd)

    def loss_and_grads():
        g = torch.Generator(device="cuda")
        g.manual_seed(0)
        p = {k: v.clone().requires_grad_() for k, v in p0.items()}
        loss = model.loss(p, Xd, yd, g)
        loss.backward()
        return float(loss), {k: v.grad for k, v in p.items()}

    km.reset_launch_counts()
    lk, gk = loss_and_grads()
    kernel_launches = _dtype_counts(km)
    with plain_kernels(km):
        km.reset_launch_counts()
        lp, gpl = loss_and_grads()
        plain_launches = _dtype_counts(km)
    model = dataclasses.replace(model, precision="highest")
    lh, _ = loss_and_grads()
    mll_gap = abs(lk - lh) / Xd.shape[0]
    grads = {k: float((gk[k] - gpl[k]).abs().max() / gpl[k].abs().max()) for k in gk}
    emit({"phase": "train_mixed_prefix", "max_cg_iters": PREFIX_ITERS,
          "loss": {"kernel": lk, "plain": lp}, "loss_rel_err": abs(lk - lp) / abs(lp),
          "grad_rel_err": grads, "loss_rtol": MIXED_PREFIX_TOL["rtol"], "grad_rtol": MIXED_GRAD_RTOL,
          "kernel_launches": kernel_launches, "plain_launches": plain_launches,
          "loss_highest": lh, "mll_per_point_vs_highest": mll_gap, "mll_tol": MIXED_MLL_PER_POINT})
    check(mll_gap <= MIXED_MLL_PER_POINT, f"mixed prefix MLL {mll_gap:.3e} per point from highest")
    check(sum(plain_launches.values()) == 0, "the plain mixed training path launched a kernel")
    check(kernel_launches["B3_bf16"] == PREFIX_ITERS, f"mixed prefix launches {kernel_launches}")
    check(abs(lk - lp) <= MIXED_PREFIX_TOL["rtol"] * abs(lp), f"mixed prefix MLL {lk} vs plain {lp}")
    for k, r in grads.items():
        check(r <= MIXED_GRAD_RTOL, f"mixed prefix gradient {k}: relative error {r:.3e}")


# --------------------------------------------------------------------------
# the batched engine (multi-output, multi-restart) and the partitioned path
# --------------------------------------------------------------------------

#: targets of the multi-output slice: y and three more of the same recipe
OUTPUTS = 4
#: the multi-restart slice: b hyperparameter sets, each a dense K of this n
RESTART_N = 8_192
#: the partitioned slice's n, and the million-row one's
PARTITIONED_N = 200_000
MILLION_N = 1_000_000
#: the reference's own tolerances for the batched and partitioned engines
#: (tests/test_batched_engine.py, tests/test_partitioned.py)
BATCH_MLL_RTOL = 1e-5
BATCH_GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
PANEL_TOL = dict(rtol=1e-4, atol=1e-4)
PANEL_VJP_TOL = dict(rtol=2e-3, atol=1e-4)
WITNESS_ROWS = 512
#: the reported residual against the true one (tests/test_mbcg.py:185)
RESIDUAL_TOL = dict(rtol=1e-4, atol=1e-6)
#: the panel heights the sweep times at n = PARTITIONED_N (one wave of B1
#: row blocks is 132 · 3 · 64 = 25,344 rows on an H100), and the cuda
#: backend's default there (ops.cuda_panel_rows on the card's SM count)
SWEEP_ROWS = (8_192, 16_384, 25_344, 32_768, 50_688, 65_536, 101_376, PARTITIONED_N)
MILLION_PEAK_BYTES = 2e9


def _million_data(seed, n):
    """The reference's million recipe (benchmarks/million.py:56-68): X ~
    N(0, I₄), y = sin(2x₀) + 0.1ε; RBF with ℓ = 0.25, s = 1, σ² = 1."""
    rng = np.random.default_rng([seed, n])
    X = rng.standard_normal((n, 4)).astype("float32")
    y = (np.sin(2 * X[:, 0]) + 0.1 * rng.standard_normal(n)).astype("float32")
    return torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()


def _million_params():
    from repro_torch import params_from_jax

    return params_from_jax({"raw_lengthscale": np.float32(inv_softplus(0.25)),
                            "raw_outputscale": np.float32(inv_softplus(1.0)),
                            "raw_noise": np.float32(inv_softplus(1.0))}, device="cuda")


def _rel_max(out, ref) -> float:
    """max |Δ| over the largest |ref|."""
    return float((out.double() - ref.double()).abs().max() / ref.double().abs().max())


def _grad_rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _rows_f64(Xs, M, rows, outputscale, sigma2, kernel_type, chunk=64, bf16=False):
    """(K(X, X) + σ²I)[rows, :]·M in float64 from the f32 inputs, a chunk
    of rows at a time (K from differences): the row witness.  With
    ``bf16`` the bf16 kernels' factors: the entries formed in f32 as the
    plain version forms them, σ² on the diagonal, rounded to bf16 (M is
    the caller's, rounded as the kernel reads it), summed in float64."""
    from repro_torch.kernels.kernel_matmul.ref import _sq_dist, apply_stationary

    X, Md = (Xs if bf16 else Xs.double()), M.double()
    out = []
    for i in range(0, rows.numel(), chunk):
        r = rows[i : i + chunk]
        K = apply_stationary(kernel_type, _sq_dist(X[r], X), outputscale)
        if bf16:
            K[torch.arange(r.numel(), device=K.device), r] += sigma2
            out.append(K.to(torch.bfloat16).double() @ Md)
        else:
            out.append(K @ Md + sigma2 * Md[r])
    return torch.cat(out)


def _vjp_rows_f64_rbf(Xs, M, C, rows, outputscale, chunk=64):
    """Rows of ∂/∂Xs ⟨C, K(X, X)·M⟩ for the RBF kernel (one X on both sides)
    in float64 from the f32 inputs, a chunk of rows at a time: row i is
    Σⱼ wᵢⱼ·∂k(xᵢ, xⱼ)/∂xᵢ with wᵢⱼ = ⟨Cᵢ, Mⱼ⟩ + ⟨Mᵢ, Cⱼ⟩ and ∂k/∂xᵢ =
    −k(xᵢ, xⱼ)(xᵢ − xⱼ): the row witness of the panel-streamed VJP."""
    from repro_torch.kernels.kernel_matmul.ref import _sq_dist, apply_stationary

    X, Md, Cd = Xs.double(), M.double(), C.double()
    out = []
    for i in range(0, rows.numel(), chunk):
        r = rows[i : i + chunk]
        P = apply_stationary("rbf", _sq_dist(X[r], X), outputscale)
        P.mul_(Cd[r] @ Md.T + Md[r] @ Cd.T)
        out.append(P @ X - P.sum(1, keepdim=True) * X[r])
    return torch.cat(out)


def phase_batched_kernel(km, plain, rng, n, errs):
    """B2 at the multi-output slice's shape (n = 40,000, b = 4, t = 9):
    against four B1 launches (the same bits expected); its gradient — the
    batched product's autograd Function, one gradient-kernel launch over
    the batch folded into columns — against the sum over the batch of the
    plain version's symmetric VJPs, 2e-4 relative; bf16 B2 against its
    bf16 plain version, BF16_REL_TOL of the largest output."""
    from repro_torch.kernels.kernel_matmul.ops import fused_kernel_matmul_prescaled
    from repro_torch.kernels.kernel_matmul.ref import kernel_matmul_grad_sym_plain

    dev = torch.device("cuda")
    d, t = 8, 9
    X = rng.uniform(-1, 1, (n, d)).astype("float32")
    Xs = torch.from_numpy(X / 0.5).to(dev)
    M = _randn(rng, (OUTPUTS, n, t), dev)
    C = _randn(rng, (OUTPUTS, n, t), dev)
    b2 = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.1, kernel_type="matern52")
    b1 = torch.stack([km.kernel_matmul_cuda(Xs, Xs, M[i], 1.0, 0.1, kernel_type="matern52")
                      for i in range(OUTPUTS)])
    b2_vs_b1 = _err(b2, b1)
    b2_rel = b2_vs_b1 / float(b1.abs().max())

    Xg = Xs.clone().requires_grad_()
    s = torch.tensor(1.0, device=dev, requires_grad=True)
    s2 = torch.tensor(0.1, device=dev, requires_grad=True)
    km.reset_launch_counts()
    out = fused_kernel_matmul_prescaled(Xg, Xg, M, s, s2, kernel_type="matern52")
    gX, gs, gs2 = torch.autograd.grad(out, (Xg, s, s2), C)
    torch.cuda.synchronize()
    launches = {"B2": km.batched_launches, "B1": km.launches, "grad": km.grad_launches}
    want = [torch.zeros_like(Xs), 0.0, 0.0]
    for i in range(OUTPUTS):
        w = kernel_matmul_grad_sym_plain(Xs, M[i], C[i], 1.0, 0.1, kernel_type="matern52")
        want = [a + b for a, b in zip(want, w)]
    grad_rel = {"X": _grad_rel(gX, want[0]),
                "outputscale": abs(float(gs - want[1])) / abs(float(want[1])),
                "sigma2": abs(float(gs2 - want[2])) / abs(float(want[2]))}
    errs["grad"] = max(errs["grad"], _err(gX, want[0]))

    Xb = Xs.to(torch.bfloat16).float()
    bf = km.kernel_matmul_cuda(Xb, Xb, M, 1.0, 0.1, kernel_type="matern52",
                               compute_dtype="bfloat16")
    bf_ref = plain(Xb, Xb, M, 1.0, 0.1, kernel_type="matern52", compute_dtype="bfloat16")
    bf_rel = _rel_max(bf, bf_ref)
    errs["B2_bf16"] = max(errs["B2_bf16"], _err(bf, bf_ref))
    emit({"phase": "batched_kernel", "n": n, "batch": OUTPUTS, "t": t,
          "b2_vs_four_b1_max_abs": b2_vs_b1, "b2_vs_four_b1_rel": b2_rel,
          "b2_grad_rel_err": grad_rel, "grad_tol_rel": REL_TOL, "backward_launches": launches,
          "b2_bf16_vs_plain_rel": bf_rel, "bf16_tol_rel": BF16_REL_TOL})
    check(b2_rel <= REL_TOL, f"B2 vs four B1 launches: {b2_rel:.3e} of the largest output")
    check(launches == {"B2": 1, "B1": 0, "grad": 1}, f"B2 forward + backward launches {launches}")
    for k, r in grad_rel.items():
        check(r <= REL_TOL, f"B2 gradient {k}: relative error {r:.3e} > {REL_TOL}")
    check(bf_rel <= BF16_REL_TOL, f"bf16 B2 vs its plain version: {bf_rel:.3e}")


def _multi_output_data(seed, n, d=8):
    """The serving data's X and y, and OUTPUTS - 1 more targets of the same
    recipe (fresh noise), drawn from the seed."""
    X, y = make_data(np.random.default_rng(seed), n, d)
    rng = np.random.default_rng([seed, 4])
    more = [(np.sin(3 * X[:, 0]) * np.cos(2 * X[:, -1]) + 0.05 * rng.standard_normal(n))
            for _ in range(OUTPUTS - 1)]
    Y = np.stack([y] + [m.astype("float32") for m in more])
    return torch.from_numpy(X).cuda(), torch.from_numpy(Y).cuda()


def _generator(seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _loss_and_grads(model, p0, Xd, Y):
    """The summed loss of ``model`` on targets Y and its gradients, the
    probes from a fresh generator of seed 0."""
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    loss = model.loss(p, Xd, Y, _generator())
    loss.sum().backward()
    return loss.detach(), {k: v.grad for k, v in p.items()}


def phase_multi_output(km, seed, n):
    """Multi-output serving and training: ExactGP(matern52, mode="cuda") on
    the serving X with Y (4, n); ``loss`` returns (4,) from ONE engine call
    over (4, n, 9), its backward one gradient-kernel launch.  Unfused at
    precond_rank=5 (B2 f32 every iteration), fused at precond_rank=0 (B3
    with b = 4) and under precision="mixed" (bf16 B2 every iteration, f32
    B2 for the refreshes): launches counted, forward + backward timed.
    Over a PREFIX_ITERS prefix each against the loop of 4 single-output
    losses from the same generator (BATCH_MLL_RTOL; gradients
    BATCH_GRAD_TOL), and "mixed" against "highest" (MIXED_MLL_PER_POINT).
    ``engine_state`` and ``solve`` with a (4, n) / (4, n, 9) right-hand
    side."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings, engine_state, solve

    Xd, Y = _multi_output_data(seed, n)
    p = 25
    refreshes = p // 2
    configs = {
        "unfused": dict(fuse_cg=False, precision="highest", rank=5),
        "fused": dict(fuse_cg=True, precision="highest", rank=0),
        "mixed": dict(fuse_cg=False, precision="mixed", rank=5),
    }
    want = {"unfused": {"fwd": {"B2": p}, "bwd": {"B2": 1, "grad": 1}},
            "fused": {"fwd": {"B3": p}, "bwd": {"B2": 1, "grad": 1}},
            "mixed": {"fwd": {"B2_bf16": p, "B2": refreshes + 1}, "bwd": {"B2": 1, "grad": 1}}}
    totals = {k: 0 for k in _dtype_counts(km)}
    rows, prefix_losses = {}, {}
    for name, c in configs.items():
        settings = BBMMSettings(num_probes=8, max_cg_iters=p, precond_rank=c["rank"])
        gp = ExactGP(kernel_type="matern52", mode="cuda", fuse_cg=c["fuse_cg"],
                     precision=c["precision"], settings=settings)
        p0 = gp.init_params(Xd)
        params = {k: v.clone().requires_grad_() for k, v in p0.items()}
        km.reset_launch_counts()
        loss, fwd_ms, _ = timed(lambda: gp.loss(params, Xd, Y, _generator()))
        fwd = _dtype_counts(km)
        km.reset_launch_counts()
        _, bwd_ms, _ = timed(lambda: loss.sum().backward())
        bwd = _dtype_counts(km)
        for k in totals:
            totals[k] += fwd[k] + bwd[k]
        _, warm_ms, _ = timed(lambda: _loss_and_grads(gp, p0, Xd, Y))

        # the prefix: the (4,) loss and its gradients against the loop
        short = dataclasses.replace(gp, settings=dataclasses.replace(settings,
                                                                     max_cg_iters=PREFIX_ITERS))
        lb, gb = _loss_and_grads(short, p0, Xd, Y)
        loop, gl = [], {k: torch.zeros_like(v) for k, v in p0.items()}
        for i in range(OUTPUTS):
            li, gi = _loss_and_grads(short, p0, Xd, Y[i])
            loop.append(li)
            for k in gl:
                gl[k] += gi[k]
        loop = torch.stack(loop)
        prefix_losses[name] = lb
        loss_rel = float(((lb - loop).abs() / loop.abs()).max())
        grad_rel = {k: _grad_rel(gb[k], gl[k]) for k in gb}
        grad_ok = all(_within(gb[k], gl[k], BATCH_GRAD_TOL) for k in gb)
        rows[name] = {"loss": loss.tolist(), "forward_ms": fwd_ms, "backward_ms": bwd_ms,
                      "warm_step_ms": warm_ms, "launches": {"forward": fwd, "backward": bwd},
                      "prefix_loss_vs_loop_rel": loss_rel, "prefix_grad_vs_loop_rel": grad_rel}
        emit({"phase": "multi_output", "config": name, "n": n, "outputs": OUTPUTS,
              "settings": {"num_probes": 8, "max_cg_iters": p, "precond_rank": c["rank"],
                           "fuse_cg": c["fuse_cg"], "precision": c["precision"]},
              **rows[name], "mll_rtol": BATCH_MLL_RTOL, "grad_tol": BATCH_GRAD_TOL})
        check(loss.shape == (OUTPUTS,) and bool(torch.isfinite(loss).all()),
              f"multi-output {name}: loss {loss.tolist()}")
        for phase_name, got in (("fwd", fwd), ("bwd", bwd)):
            exp = {k: 0 for k in got} | want[name][phase_name]
            check(got == exp, f"multi-output {name} {phase_name} launches {got} != {exp}")
        check(loss_rel <= BATCH_MLL_RTOL, f"multi-output {name}: prefix loss vs loop {loss_rel:.3e}")
        check(grad_ok, f"multi-output {name}: prefix gradients vs loop {grad_rel}")
    gap = float((prefix_losses["mixed"] - prefix_losses["unfused"]).abs().max()) / n
    # engine_state and solve with a batched right-hand side
    gp = ExactGP(kernel_type="matern52", mode="cuda",
                 settings=BBMMSettings(num_probes=8, max_cg_iters=PREFIX_ITERS, precond_rank=5))
    params = gp.init_params(Xd)
    op = gp.operator(params, Xd)
    st = engine_state(op, Y, _generator(), gp.settings)
    U = solve(op, st.probes, gp.settings)
    emit({"phase": "multi_output_state", "mll_per_point_mixed_vs_highest": gap,
          "mll_tol": MIXED_MLL_PER_POINT, "engine_state_shapes": [list(st.solve_y.shape),
                                                                 list(st.probe_solves.shape)],
          "solve_shape": list(U.shape)})
    check(gap <= MIXED_MLL_PER_POINT, f"multi-output mixed vs highest: {gap:.3e} per point")
    check(st.solve_y.shape == (OUTPUTS, n) and st.probe_solves.shape == (OUTPUTS, n, 8)
          and U.shape == (OUTPUTS, n, 8), "multi-output engine_state / solve shapes")
    check(bool(torch.isfinite(st.solve_y).all() & torch.isfinite(U).all()),
          "multi-output engine_state / solve: non-finite")
    return totals, rows


def phase_multi_restart(km, seed):
    """Multi-restart: ``ExactGP.batched_loss`` with 4 hyperparameter sets at
    n = RESTART_N (4 dense K, formed outside any kernel as the reference
    forms them) against a loop of ``loss`` (mode="dense", the same K) from
    the same generator, BATCH_MLL_RTOL, at full depth and over the prefix
    at precond_rank=0, and at full depth at precond_rank=5: the batched
    preconditioner pivots on the kernels' exact diagonals k(x, x), as the
    loop's does (not on the materialized K's, whose distance expansion
    rounds them ~3e-6 apart and breaks their ties), so the two build the
    same factors and draw the same probes.  No kernel of the port runs
    here."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings

    X, y = make_data(np.random.default_rng([seed, 8]), RESTART_N, 8)
    Xd, yd = torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()
    out = {}
    for rank, iters in ((0, 25), (0, PREFIX_ITERS), (5, 25)):
        gp = ExactGP(kernel_type="matern52", mode="dense",
                     settings=BBMMSettings(num_probes=8, max_cg_iters=iters, precond_rank=rank))
        p0 = gp.init_params(Xd)
        batch = {k: torch.stack([v, v + 0.3, v - 0.2, v + 0.1]) for k, v in p0.items()}
        torch.cuda.reset_peak_memory_stats()
        km.reset_launch_counts()
        lb, ms, _ = timed(lambda: gp.batched_loss(batch, Xd, yd, _generator()))
        peak = torch.cuda.max_memory_allocated()
        launches = sum(_dtype_counts(km).values())
        loop = torch.stack([gp.loss({k: v[i] for k, v in batch.items()}, Xd, yd, _generator())
                            for i in range(4)])
        rel = float(((lb - loop).abs() / loop.abs()).max())
        out[f"rank{rank}_iters{iters}"] = rel
        emit({"phase": "multi_restart", "n": RESTART_N, "restarts": 4, "precond_rank": rank,
              "max_cg_iters": iters, "batched_loss": lb.tolist(), "loop_loss": loop.tolist(),
              "rel_err": rel, "rtol": BATCH_MLL_RTOL,
              "batched_loss_ms": ms, "peak_device_bytes": peak, "kernel_launches": launches})
        check(bool(torch.isfinite(lb).all()), "multi-restart: non-finite loss")
        check(rel <= BATCH_MLL_RTOL,
              f"multi-restart (rank {rank}, {iters} iterations): batched vs loop {rel:.3e}")
    return out


def _panel_counts(km):
    return {"B1": km.launches, "B1_bf16": km.bf16_launches, "B3": km.fused_launches,
            "B3_bf16": km.bf16_fused_launches, "grad": km.grad_launches,
            "panels": km.panel_launches}


def phase_panel_parity(km, seed, errs):
    """The panel streams at n = PARTITIONED_N (the million recipe, t = 9)
    against the full-range launches: the streamed K·M against B1 (PANEL_TOL;
    the max difference printed, 0 expected when the panel height is a
    multiple of 64), 512 of its rows against a float64 K[rows, :]·M (2e-4
    of the largest output); the panel-fused step against B3 (state
    FUSED_STATE_TOL, reductions 2e-3) and its launches per CG iteration
    against num_panels; the panel-streamed VJP against the one-launch
    symmetric VJP (PANEL_VJP_TOL); one bf16 panel-fused step against the
    bf16 full-range B3 (BF16_REL_TOL).  A fault the panel and full-range
    launches share would pass those, so each panel stream is also held on
    the same 512 rows to float64: the fused step's U′, R′, D′ to the
    elementwise update (FUSED_STATE_TOL) and its V′ to K̂[rows, :]·D′ with
    that D′ (2e-4 of the largest); the VJP's rows to a float64 VJP of
    those rows (2e-4 of the largest, the gradient kernel's gate); the bf16
    step's D′ to the update and its V′ to the bf16-rounded factors
    (BF16_REL_TOL)."""
    from repro_torch.core import PartitionedKernelOperator, panel_accounting
    from repro_torch.gp import RBFKernel
    from repro_torch.kernels.kernel_matmul.ops import (
        panel_fused_cg_step_prescaled,
        panel_matmul_prescaled,
        panel_vjp_prescaled,
    )

    n, t = PARTITIONED_N, 9
    Xd, _ = _million_data(seed, n)
    Xs = (Xd / 0.25).contiguous()
    rng = np.random.default_rng([seed, 200])
    M = _randn(rng, (n, t), Xd.device)
    kern = RBFKernel(lengthscale=torch.tensor(0.25, device="cuda"),
                     outputscale=torch.tensor(1.0, device="cuda"))
    op = PartitionedKernelOperator(kernel=kern, X=Xd)
    p = op.panel_rows_for(n)
    num_panels = -(-n // p)
    stats = {"panel_rows": p, "num_panels": num_panels}

    km.reset_launch_counts()
    with panel_accounting() as records:
        streamed = op.matmul(M)
    torch.cuda.synchronize()
    stats["matmul_launches"] = _panel_counts(km)
    full = km.kernel_matmul_cuda(Xs, Xs, M, 1.0, 0.0, kernel_type="rbf")
    stats["streamed_vs_full_max_abs"] = _err(streamed, full)
    rows = torch.from_numpy(rng.choice(n, WITNESS_ROWS, replace=False)).cuda()
    w = _rows_f64(Xs, M, rows, 1.0, 0.0, "rbf")
    stats["streamed_vs_f64_rows_rel"] = _rel_max(streamed[rows], w)
    stats["full_vs_f64_rows_rel"] = _rel_max(full[rows], w)
    errs["B1"] = max(errs["B1"], _err(streamed[rows], w))

    state, scalars = _cg_inputs(rng, Xd.device, 1, n, t)
    full_step = km.fused_cg_step_cuda(Xs, Xs, *state, *state[1:], *scalars, 1.0, 1.0,
                                      kernel_type="rbf")
    km.reset_launch_counts()
    with panel_accounting() as records:
        step = op.fused_cg_step_fn(sigma2=torch.tensor(1.0, device="cuda"))
        panel_step = step(*(x[0] for x in state), *(x[0] for x in scalars))
    torch.cuda.synchronize()
    stats["fused_step_launches"] = _panel_counts(km)
    stats["fused_record"] = {"num_panels": records[0].num_panels, "panel_rows": records[0].panel_rows}
    state_err = max(_err(a, b[0]) for a, b in zip(panel_step[:4], full_step[:4]))
    state_ok = all(_within(a, b[0], FUSED_STATE_TOL) for a, b in zip(panel_step[:4], full_step[:4]))
    red = torch.stack(panel_step[4], dim=0)
    red_rel = _rel_max(red, full_step[4][0])
    stats["fused_state_max_abs"], stats["fused_red_rel"] = state_err, red_rel
    errs["B3"] = max(errs["B3"], state_err)
    exact = [x[0] for x in _advance_f64(state, scalars)]  # U′, R′, D′
    v64 = _rows_f64(Xs, exact[2], rows, 1.0, 1.0, "rbf")
    stats["fused_vs_f64_U_R_D_max_abs"] = [_err(a, b) for a, b in zip(panel_step[:3], exact)]
    stats["fused_V_vs_f64_rows_rel"] = _rel_max(panel_step[3][rows], v64)
    f64_state_ok = all(_within(a, b, FUSED_STATE_TOL) for a, b in zip(panel_step[:3], exact))
    errs["B3"] = max(errs["B3"], _err(panel_step[3][rows], v64))
    del exact, v64

    C = _randn(rng, (n, t), Xd.device)
    km.reset_launch_counts()
    gX, gs = panel_vjp_prescaled(Xs, M, C, 1.0, p, kernel_type="rbf")
    torch.cuda.synchronize()
    stats["vjp_grad_launches"] = km.grad_launches
    wX, ws, _ = km.kernel_matmul_grad_sym_cuda(Xs, M, C, 1.0, 0.0, kernel_type="rbf")
    stats["vjp_X_max_abs"] = _err(gX, wX)
    stats["vjp_outputscale_rel"] = abs(float(gs - ws)) / abs(float(ws))
    g64 = _vjp_rows_f64_rbf(Xs, M, C, rows, 1.0)
    stats["vjp_X_vs_f64_rows_rel"] = _rel_max(gX[rows], g64)
    errs["grad"] = max(errs["grad"], stats["vjp_X_max_abs"], _err(gX[rows], g64))

    Xb = Xs.to(torch.bfloat16).float()
    full_bf = km.fused_cg_step_cuda(Xb, Xb, *state, *state[1:], *scalars, 1.0, 1.0,
                                    kernel_type="rbf", compute_dtype="bfloat16")
    km.reset_launch_counts()
    panel_bf = panel_fused_cg_step_prescaled(Xb, *state, *scalars, 1.0, 1.0, panel_rows=p,
                                             kernel_type="rbf", compute_dtype="bfloat16")
    stats["bf16_fused_step_launches"] = _panel_counts(km)
    bf_state = max(_rel_max(a, b) for a, b in zip(panel_bf[:4], full_bf[:4]))
    bf_red = _rel_max(torch.stack(panel_bf[4], dim=-2), full_bf[4])
    stats["bf16_fused_state_rel"], stats["bf16_fused_red_rel"] = bf_state, bf_red
    errs["B3_bf16"] = max(errs["B3_bf16"], max(_err(a, b) for a, b in zip(panel_bf[:4], full_bf[:4])))
    d64 = _advance_f64(state, scalars)[2][0]
    v64 = _rows_f64(Xb, panel_bf[2][0].to(torch.bfloat16), rows, 1.0, 1.0, "rbf", bf16=True)
    stats["bf16_fused_D_vs_f64_max_abs"] = _err(panel_bf[2][0], d64)
    stats["bf16_fused_V_vs_f64_rows_rel"] = _rel_max(panel_bf[3][0, rows], v64)
    bf_f64_ok = _within(panel_bf[2][0], d64, FUSED_STATE_TOL)
    del d64, v64
    emit({"phase": "panel_parity", "n": n, "t": t, **stats, "panel_tol": PANEL_TOL,
          "vjp_tol": PANEL_VJP_TOL})
    check(_within(streamed, full, PANEL_TOL), f"streamed K·M vs B1: {stats['streamed_vs_full_max_abs']:.3e}")
    check(stats["streamed_vs_f64_rows_rel"] <= REL_TOL,
          f"streamed K·M vs f64 rows: {stats['streamed_vs_f64_rows_rel']:.3e}")
    check(stats["matmul_launches"]["B1"] == stats["matmul_launches"]["panels"] == num_panels,
          f"streamed matmul launches {stats['matmul_launches']} != {num_panels} panels")
    check(state_ok, f"panel-fused step state vs B3: {state_err:.3e}")
    check(f64_state_ok, f"panel-fused step U′, R′, D′ vs float64: "
          f"{stats['fused_vs_f64_U_R_D_max_abs']}")
    check(stats["fused_V_vs_f64_rows_rel"] <= REL_TOL,
          f"panel-fused V′ vs f64 rows: {stats['fused_V_vs_f64_rows_rel']:.3e}")
    check(red_rel <= FUSED_RED_TOL["atol"], f"panel-fused reductions vs B3: {red_rel:.3e}")
    check(stats["fused_step_launches"]["B3"] == stats["fused_step_launches"]["panels"]
          == records[0].num_panels == num_panels,
          f"panel-fused launches per iteration {stats['fused_step_launches']} != {num_panels}")
    check(stats["vjp_grad_launches"] == num_panels, f"panel VJP launches {stats['vjp_grad_launches']}")
    check(_within(gX, wX, PANEL_VJP_TOL) and stats["vjp_outputscale_rel"] <= PANEL_VJP_TOL["rtol"],
          f"panel VJP vs the symmetric VJP: X {stats['vjp_X_max_abs']:.3e}, "
          f"outputscale {stats['vjp_outputscale_rel']:.3e}")
    check(stats["vjp_X_vs_f64_rows_rel"] <= REL_TOL,
          f"panel VJP rows vs float64: {stats['vjp_X_vs_f64_rows_rel']:.3e}")
    check(stats["bf16_fused_step_launches"]["B3_bf16"] == num_panels, "bf16 panel-fused launches")
    check(bf_f64_ok, f"bf16 panel-fused D′ vs float64: {stats['bf16_fused_D_vs_f64_max_abs']:.3e}")
    check(stats["bf16_fused_V_vs_f64_rows_rel"] <= BF16_REL_TOL,
          f"bf16 panel-fused V′ vs f64 rows: {stats['bf16_fused_V_vs_f64_rows_rel']:.3e}")
    check(max(bf_state, bf_red) <= BF16_REL_TOL, f"bf16 panel-fused step vs bf16 B3: {bf_state:.3e}, {bf_red:.3e}")
    return stats


def phase_panel_sweep(km, seed):
    """The panel height at n = PARTITIONED_N, t = 9: the streamed K·M and
    the panel-fused step timed (CUDA events) at each of SWEEP_ROWS — the
    last, n, is the full-range launch — and at the cuda backend's default
    height on this card, the data that default rests on."""
    from repro_torch.kernels.kernel_matmul.ops import (
        cuda_panel_rows,
        panel_fused_cg_step_prescaled,
        panel_matmul_prescaled,
    )

    n, t = PARTITIONED_N, 9
    default = cuda_panel_rows(n, torch.cuda.get_device_properties(0).multi_processor_count)
    Xd, _ = _million_data(seed, n)
    Xs = (Xd / 0.25).contiguous()
    rng = np.random.default_rng([seed, 201])
    M = _randn(rng, (n, t), Xd.device)
    state, scalars = _cg_inputs(rng, Xd.device, 1, n, t)
    table = []
    for p in sorted(set(SWEEP_ROWS) | {default}):
        mm = time_ms(lambda: panel_matmul_prescaled(Xs, M, 1.0, p, kernel_type="rbf"), reps=3)
        fs = time_ms(lambda: panel_fused_cg_step_prescaled(Xs, *state, *scalars, 1.0, 1.0,
                                                           panel_rows=p, kernel_type="rbf"),
                     reps=3)
        table.append({"panel_rows": p, "num_panels": -(-n // p), "matmul_ms": mm,
                      "fused_step_ms": fs})
    emit({"phase": "panel_sweep", "n": n, "t": t, "d": 4, "kernel": "rbf",
          "default_panel_rows": default, "table": table})
    return table


def phase_serve_partitioned(km, seed):
    """Serving at n = PARTITIONED_N on ExactGP(rbf, mode="cuda_partitioned")
    with the million recipe: over a PREFIX_ITERS prefix the engine state
    (MLL, solves) against mode="cuda" (the full-range launches), MLL rtol
    1e-4 and solves PANEL_TOL; then the posterior cache at precond_rank=5
    (timed cold and warm; one launch per panel per CG iteration and for
    the Gram product), one 1,024-point predict_cached, the SolveReport
    status and peak memory.  The uncached 256-point predict is left out
    for time (~50 streamed launches at t = 256)."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings, engine_state, health, panel_accounting

    n = PARTITIONED_N
    Xd, yd = _million_data(seed, n)
    params = _million_params()
    settings = BBMMSettings(num_probes=8, max_cg_iters=25, cg_tol=1e-2, precond_rank=5)
    short = dataclasses.replace(settings, max_cg_iters=PREFIX_ITERS)
    prefix = {}
    for mode in ("cuda_partitioned", "cuda"):
        gp = ExactGP(kernel_type="rbf", mode=mode, settings=short)
        st = engine_state(gp.operator(params, Xd), yd, _generator(), short)
        prefix[mode] = st
    a, b = prefix["cuda_partitioned"], prefix["cuda"]
    mll = {m: float(-0.5 * (s.inv_quad + s.logdet)) for m, s in prefix.items()}
    mll_rel = abs(mll["cuda_partitioned"] - mll["cuda"]) / abs(mll["cuda"])
    solves_ok = _within(a.solve_y, b.solve_y, PANEL_TOL) and _within(a.probe_solves, b.probe_solves,
                                                                      PANEL_TOL)

    gp = ExactGP(kernel_type="rbf", mode="cuda_partitioned", settings=settings)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.reset_launch_counts()
    with health.collect() as reports, panel_accounting() as records:
        cache, build_ms, build_dev_ms = timed(lambda: gp.posterior_cache(params, Xd, yd))
    build = _panel_counts(km)
    peak = torch.cuda.max_memory_allocated()
    warm = [timed(lambda: gp.posterior_cache(params, Xd, yd))[1] for _ in range(2)]
    q = torch.from_numpy(np.random.default_rng([seed, 202]).standard_normal((1024, 4)).astype(
        "float32")).cuda()
    km.reset_launch_counts()
    (mean, var), req_ms, _ = timed(lambda: gp.predict_cached(params, Xd, cache, q))
    req_warm = [timed(lambda: gp.predict_cached(params, Xd, cache, q))[1] for _ in range(3)]
    req = _panel_counts(km)
    num_panels = records[0].num_panels
    emit({"phase": "serve_partitioned", "n": n, "d": 4, "kernel": "rbf",
          "settings": {"num_probes": 8, "max_cg_iters": 25, "cg_tol": 1e-2, "precond_rank": 5},
          "prefix_mll": mll, "prefix_mll_rel": mll_rel,
          "prefix_solve_max_abs": _err(a.solve_y, b.solve_y),
          "prefix_probe_solves_max_abs": _err(a.probe_solves, b.probe_solves),
          "build_ms": build_ms, "build_device_ms": build_dev_ms, "build_warm_ms": warm,
          "request_ms": req_ms, "request_warm_ms": req_warm,
          "launches": {"build": build, "requests": req},
          "panel_rows": records[0].panel_rows, "num_panels": num_panels,
          "panel_records": len(records),
          "panel_bytes": records[0].panel_bytes, "dense_bytes": records[0].dense_bytes,
          "peak_device_bytes": peak,
          "health": [{"status": r.status, "residual_norm": r.residual_norm} for r in reports]})
    check(mll_rel <= MLL_RTOL, f"partitioned prefix MLL vs cuda: {mll_rel:.3e}")
    check(solves_ok, "partitioned prefix solves vs cuda outside PANEL_TOL")
    check(build["B1"] == build["panels"] == 26 * num_panels,
          f"cache build launches {build} != 26 × {num_panels} panels")
    check(sum(req.values()) == 0, f"predict_cached launched {req}")
    # the recipe is well conditioned (σ² = 1): a healthy build converges or
    # runs out of iterations, never worse
    check(reports[-1].status in ("CONVERGED", "MAX_ITERS"),
          f"partitioned cache build: {reports[-1].describe()}")
    check(bool(torch.isfinite(mean).all() & torch.isfinite(var).all() & (var > 0).all()),
          "partitioned serving output")
    return {k: build[k] for k in ("B1",)}, {"build_ms": build_ms, "build_warm_ms": warm,
                                            "request_warm_ms": req_warm, "peak": peak}


def phase_train_partitioned(km, seed):
    """Training at n = PARTITIONED_N on ExactGP(rbf, mode="cuda_partitioned",
    fuse_cg=True, precond_rank=0) with the million recipe: over a
    PREFIX_ITERS prefix the MLL and its gradients against mode="cuda"
    (fused, full range), MLL rtol 1e-4, gradients PANEL_VJP_TOL; two Adam
    steps from the recipe's hyperparameters (``loss`` / ``backward``, as
    ``fit_gp`` steps; the same Adam settings), each timed with its
    launches: B3 once per panel per CG iteration, the backward's primal
    and the gradient kernel once per panel; one mixed panel-fused step
    (bf16 B3 per panel per iteration, f32 refreshes streamed); peak
    memory."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings, panel_accounting
    from repro_torch.gp.training import ADAM_BETAS, ADAM_EPS

    n = PARTITIONED_N
    Xd, yd = _million_data(seed, n)
    p0 = _million_params()
    settings = BBMMSettings(num_probes=8, max_cg_iters=25, precond_rank=0)
    short = dataclasses.replace(settings, max_cg_iters=PREFIX_ITERS)
    prefix = {}
    for mode in ("cuda_partitioned", "cuda"):
        gp = ExactGP(kernel_type="rbf", mode=mode, fuse_cg=True, settings=short)
        prefix[mode] = _loss_and_grads(gp, p0, Xd, yd)
    (la, ga), (lb, gb) = prefix["cuda_partitioned"], prefix["cuda"]
    mll_rel = abs(float(la - lb)) / abs(float(lb))
    grad_rel = {k: _grad_rel(ga[k], gb[k]) for k in ga}
    grads_ok = all(_within(ga[k], gb[k], PANEL_VJP_TOL) for k in ga)

    gp = ExactGP(kernel_type="rbf", mode="cuda_partitioned", fuse_cg=True, settings=settings)
    params = {k: v.clone().requires_grad_() for k, v in p0.items()}
    opt = torch.optim.Adam(params.values(), lr=0.1, betas=ADAM_BETAS, eps=ADAM_EPS)
    gen = _generator()
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        km.reset_launch_counts()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        with panel_accounting() as records:
            loss = gp.loss(params, Xd, yd, gen)
        fwd = _panel_counts(km)
        km.reset_launch_counts()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        steps.append({"step": i, "loss": float(loss.detach()), "ms": (time.perf_counter() - t0) * 1e3,
                      "forward": fwd, "backward": _panel_counts(km),
                      "num_panels": records[0].num_panels, "panel_rows": records[0].panel_rows})
    peak = torch.cuda.max_memory_allocated()

    mixed = ExactGP(kernel_type="rbf", mode="cuda_partitioned", fuse_cg=True, settings=settings,
                    precision="mixed")
    pm = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    km.reset_launch_counts()
    t0 = time.perf_counter()
    mloss = mixed.loss(pm, Xd, yd, _generator())
    mfwd = _panel_counts(km)
    km.reset_launch_counts()
    mloss.backward()
    torch.cuda.synchronize()
    mixed_ms = (time.perf_counter() - t0) * 1e3
    mbwd = _panel_counts(km)
    P = steps[0]["num_panels"]
    p = settings.max_cg_iters
    emit({"phase": "train_partitioned", "n": n, "d": 4, "kernel": "rbf",
          "settings": {"num_probes": 8, "max_cg_iters": p, "precond_rank": 0, "fuse_cg": True},
          "prefix_mll_rel": mll_rel, "prefix_grad_rel": grad_rel, "steps": steps,
          "mixed_step": {"loss": float(mloss.detach()), "ms": mixed_ms, "forward": mfwd, "backward": mbwd},
          "peak_device_bytes": peak, "dense_bytes": 4 * n * n})
    check(mll_rel <= MLL_RTOL, f"partitioned training prefix MLL vs cuda: {mll_rel:.3e}")
    check(grads_ok, f"partitioned training prefix gradients vs cuda: {grad_rel}")
    for st in steps:
        check(math.isfinite(st["loss"]), f"partitioned step {st['step']}: non-finite loss")
        check(st["forward"]["B3"] == st["forward"]["panels"] == p * P and st["forward"]["B1"] == 0,
              f"partitioned step {st['step']} forward launches {st['forward']} != {p} × {P}")
        check(st["backward"]["B1"] == st["backward"]["grad"] == st["backward"]["panels"] == P,
              f"partitioned step {st['step']} backward launches {st['backward']} != {P} each")
    refreshes = p // 2 + 1
    check(mfwd["B3_bf16"] == p * P and mfwd["B1"] == refreshes * P and mfwd["B3"] == 0,
          f"mixed partitioned step forward launches {mfwd}")
    check(mbwd["grad"] == P and math.isfinite(float(mloss.detach())), f"mixed partitioned step {mbwd}")
    check(all(bool(torch.isfinite(v).all()) for v in params.values()), "partitioned parameters")
    launches = {k: sum(st["forward"][k] + st["backward"][k] for st in steps) + mfwd[k] + mbwd[k]
                for k in ("B1", "B1_bf16", "B3", "B3_bf16", "grad")}
    return launches, {"step_ms": [st["ms"] for st in steps], "mixed_step_ms": mixed_ms,
                      "peak": peak}


def phase_million(km, seed):
    """n = MILLION_N, the million recipe on the cuda backend: one streamed
    K̂·M at t = 9 (timed) held on 512 rows to a float64 K̂[rows, :]·M (2e-4
    of the largest output); a 3-iteration panel-fused CG prefix over
    [y | Z] — every state finite, launches per iteration equal to
    num_panels, each iteration's U′, R′, D′ held to the float64 elementwise
    update (FUSED_STATE_TOL) and its V′ on the 512 rows to a float64
    K̂[rows, :]·D′ of that D′ (2e-4 of the largest), and the error falling
    in the norm CG minimizes: the objective φ(u) = ½uᵀK̂u − bᵀu =
    −½uᵀ(b + r) of every column (r the recursive residual; the last
    iterate's true one) strictly decreasing.  The last iterate's true
    residual comes from one more streamed product, whose launches are
    counted and whose rows are held to float64 as the first's; the
    residual the solver reports lies within RESIDUAL_TOL of it.  The
    residual's 2-norm is reported: on a wide spectrum the first step, its
    α fitted to the probes' Rayleigh quotient, overshoots the largest
    eigenvalues and raises it.  Peak device memory (the witnesses' own
    excluded) under MILLION_PEAK_BYTES, beside PanelLaunch.panel_bytes and
    dense_bytes."""
    from repro_torch import ExactGP
    from repro_torch.core import BBMMSettings, mbcg, panel_accounting

    n, t = MILLION_N, 9
    Xd, yd = _million_data(seed, n)
    Xs = (Xd / 0.25).contiguous()
    rows = torch.from_numpy(np.random.default_rng([seed, 203]).choice(
        n, WITNESS_ROWS, replace=False)).cuda()
    params = _million_params()
    gp = ExactGP(kernel_type="rbf", mode="cuda_partitioned",
                 settings=BBMMSettings(num_probes=t - 1, precond_rank=0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    op = gp.operator(params, Xd)
    Z = torch.randint(0, 2, (n, t - 1), generator=_generator(), device="cuda").float() * 2 - 1
    B = torch.cat([yd[:, None], Z], dim=1)
    prepared = op.prepare()
    km.reset_launch_counts()
    with panel_accounting() as records:
        out, mvm_ms, mvm_dev_ms = timed(lambda: prepared.matmul(B))
    mvm_launches = _panel_counts(km)
    step = op.fused_cg_step_fn()
    rr, phi, per_iter, steps_f64, peaks = [], [], [], [], []
    witness_ms = [0.0]

    def recording_step(*args):
        km.reset_launch_counts()
        res = step(*args)
        per_iter.append(_panel_counts(km))
        # the outputs' U, R are the iterate after the pending update
        phi.append(-0.5 * (res[0] * (B + res[1])).sum(0))
        rr.append(torch.sqrt(torch.clamp(res[4][1], min=0.0)))
        # the float64 witness, outside the path's time and peak memory
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        peaks.append(torch.cuda.max_memory_allocated())
        exact = _advance_f64(args[:4], args[4:])
        v64 = _rows_f64(Xs, exact[2], rows, 1.0, 1.0, "rbf")
        steps_f64.append({
            "U_R_D_max_abs": [_err(a, b) for a, b in zip(res[:3], exact)],
            "U_R_D_ok": all(_within(a, b, FUSED_STATE_TOL) for a, b in zip(res[:3], exact)),
            "V_rows_rel": _rel_max(res[3][rows], v64)})
        del exact, v64
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        witness_ms[0] += (time.perf_counter() - t0) * 1e3
        return res

    res, cg_wall_ms, _ = timed(lambda: mbcg(prepared.matmul, B, max_iters=3, tol=0.0,
                                            fused_step=recording_step))
    cg_ms = cg_wall_ms - witness_ms[0]
    peak = max(peaks + [torch.cuda.max_memory_allocated()])
    U = res.solves
    km.reset_launch_counts()
    KU = prepared.matmul(U)
    torch.cuda.synchronize()
    true_launches = _panel_counts(km)
    R = B - KU
    phi.append(-0.5 * (U * (B + R)).sum(0))
    b_norm = torch.linalg.vector_norm(B, dim=0)
    true_rel = torch.linalg.vector_norm(R, dim=0) / b_norm
    rel = [float((r / b_norm).max()) for r in rr] + [float(res.residual_norm.max())]
    true_vs_recursive = float((true_rel - res.residual_norm).abs().max())
    residual_ok = _within(res.residual_norm, true_rel, RESIDUAL_TOL)
    falling = all(bool((b < a).all()) for a, b in zip(phi, phi[1:]))
    finite = bool(torch.isfinite(U).all() & torch.isfinite(out).all() & torch.isfinite(R).all())
    witness = _rel_max(out[rows], _rows_f64(Xs, B, rows, 1.0, 1.0, "rbf"))
    true_witness = _rel_max(KU[rows], _rows_f64(Xs, U, rows, 1.0, 1.0, "rbf"))
    lau = records[0]
    emit({"phase": "million", "n": n, "d": 4, "t": t, "kernel": "rbf",
          "panel_rows": lau.panel_rows, "num_panels": lau.num_panels,
          "mvm_ms": mvm_ms, "mvm_device_ms": mvm_dev_ms, "mvm_launches": mvm_launches,
          "mvm_vs_f64_rows_rel": witness, "cg_prefix_ms": cg_ms,
          "cg_witness_ms": witness_ms[0], "cg_launches_per_iteration": per_iter,
          "cg_steps_vs_f64": steps_f64, "true_residual_launches": true_launches,
          "true_residual_product_vs_f64_rows_rel": true_witness,
          "max_rel_residual_by_iteration": rel,
          "true_vs_recursive_residual": true_vs_recursive, "residual_tol": RESIDUAL_TOL,
          "objective_by_iteration": [x.tolist() for x in phi],
          "peak_device_bytes": peak, "panel_bytes": lau.panel_bytes,
          "dense_bytes": lau.dense_bytes})
    check(witness <= REL_TOL, f"million: streamed K̂·M vs f64 rows {witness:.3e}")
    check(mvm_launches["B1"] == mvm_launches["panels"] == lau.num_panels,
          f"million: matmul launches {mvm_launches} != {lau.num_panels} panels")
    check(all(c["B3"] == c["panels"] == lau.num_panels for c in per_iter),
          f"million: launches per CG iteration {per_iter} != {lau.num_panels}")
    check(all(w["U_R_D_ok"] for w in steps_f64),
          f"million: a CG step's U′, R′, D′ vs float64: {steps_f64}")
    check(all(w["V_rows_rel"] <= REL_TOL for w in steps_f64),
          f"million: a CG step's V′ vs f64 rows: {steps_f64}")
    check(true_launches["B1"] == true_launches["panels"] == lau.num_panels,
          f"million: true-residual product launches {true_launches} != {lau.num_panels} panels")
    check(true_witness <= REL_TOL, f"million: true-residual product vs f64 rows {true_witness:.3e}")
    check(residual_ok, f"million: reported residual vs the true one {true_vs_recursive:.3e}")
    check(finite, "million: non-finite state")
    check(falling, f"million: the CG objective is not falling: {[x.tolist() for x in phi]}")
    check(peak < MILLION_PEAK_BYTES, f"million: peak device memory {peak} B")
    return {"B1": mvm_launches["B1"] + true_launches["B1"],
            "B3": sum(c["B3"] for c in per_iter)}, {
        "mvm_ms": mvm_ms, "peak": peak, "num_panels": lau.num_panels}


# --------------------------------------------------------------------------
# the LM serving slice: B4, B5 and zamba2-7b
# --------------------------------------------------------------------------

FLASH_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-4),  # tests/test_flash_ssd_pallas.py:27
             torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}  # :47
SSD_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),  # tests/test_flash_ssd_pallas.py:73
           torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}  # :85
LM_PARITY_TOL = dict(rtol=1e-3, atol=1e-3)
DECODE_TOL = dict(rtol=2e-2, atol=2e-2)  # tests/test_models_smoke.py:143-148
LM_REL_BOUND = 5e-2  # the reference's bf16 SSD tolerance, per kernel call on the model's inputs
ATTN_SLICE = (4, 32, 512, 224)  # batch, heads, positions, head dim of the shared block
SSD_SLICE = (4, 112, 512, 64, 64, 128)  # batch, heads, positions, head dim, state, chunk
LM_BATCH, LM_PROMPT, LM_GEN, LM_CACHE = 4, 512, 32, 1024
PARITY_LAYERS, PARITY_BATCH, PARITY_PROMPT = 13, 2, 256
FULL_LAYERS = 81
# per B4 / B5 call: |kernel − f64| ≤ this × |plain − f64|; B4's in-thread f32
# sums measured up to 2.05 × cuBLAS's blocked ones (PERF.md §6, PR 13)
WITNESS_FACTOR = 4.0
ROUNDING_FACTOR = 2.0  # bf16 logits: |kernel − plain| ≤ this × the one-ulp distance


def _normal(rng, shape, dev, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev, dtype)


def _product_ms(ops_bf16, ops_mixed, ops_f32):
    """Least time for matrix products on an H100 at the rate for their
    operand types: bf16 × bf16 on the tensor cores (989 TFLOP/s), a bf16
    operand times an f32 one as two bf16 products (the f32 operand split
    into a bf16 high and low half, which keeps its precision: 989 / 2),
    f32 × f32 outside the tensor cores (67 TFLOP/s; TF32 is off)."""
    return (ops_bf16 / PEAK_BF16_FLOPS + ops_mixed / (PEAK_BF16_FLOPS / 2)
            + ops_f32 / PEAK_F32_FLOPS) * 1e3


def flash_bound(b, h, sq, skv, dh, causal, dtype):
    """Least time for B4 on an H100: per head 2·sq·skv·dh operations for
    q·kᵀ (both operands in the input dtype) and as many for P·v (P is f32),
    halved under the causal mask, against q, k, v read once and o written
    once."""
    per_product = 2 * sq * skv * dh * b * h * (0.5 if causal else 1.0)
    if dtype == torch.bfloat16:
        t_ops = _product_ms(per_product, per_product, 0)
    else:
        t_ops = _product_ms(0, 0, 2 * per_product)
    nbytes = dtype.itemsize * b * h * dh * (2 * sq + 2 * skv)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ssd_bound(b, h, l, dh, ds, chunk, dtype):
    """Least time for B5 on an H100, per chunk: C·Bᵀ once per batch
    element (2c²·ds, both operands in the input dtype; the same for every
    head), and per head the masked f32 decay matrix times x (2c²·dh),
    C·h_prevᵀ and the state update (2c·dh·ds each, one f32 operand),
    against x, B, C, dt, A read once and y written once."""
    chunks = l // chunk
    cb = 2 * chunk * chunk * ds * chunks * b
    per_head = (2 * chunk * chunk * dh + 4 * chunk * dh * ds) * chunks * b * h
    if dtype == torch.bfloat16:
        t_ops = _product_ms(cb, per_head, 0)
    else:
        t_ops = _product_ms(0, 0, cb + per_head)
    nbytes = dtype.itemsize * (2 * b * h * l * dh + 2 * b * l * ds) + 4 * (b * h * l + h)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _check_close(name, out, ref, tol, cases, errs, key):
    torch.cuda.synchronize()
    abs_err, rel = rel_err(out.float(), ref.float())
    errs[key] = max(errs[key], abs_err)
    cases.append({"case": name, "max_abs_err": abs_err, "rel_err": rel})
    check(bool(torch.isfinite(out).all()), f"{name}: non-finite kernel output")
    check(_within(out.float(), ref.float(), tol), f"{name}: outside {tol} (max |Δ| {abs_err:.3e})")


def phase_flash_kernel(rng, errs):
    """B4 against ``gqa_attention_plain``: causal and not, GQA, the head
    dims the port builds for, ragged lengths, the slice's shape, f32 and
    bf16 (2e-4 / 3e-2)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    b, h, s, dh = ATTN_SLICE
    shapes = [  # (b, hq, hkv, sq, skv, dh, causal, dtype)
        (2, 4, 4, 128, 128, 64, True, f32), (2, 4, 4, 128, 128, 64, False, f32),
        (2, 4, 4, 256, 384, 32, False, f32), (1, 8, 2, 128, 128, 32, True, f32),
        *[(1, 4, 4, 128, 128, d, True, f32) for d in (32, 64, 112, 224)],
        (1, 4, 2, 200, 200, 112, True, f32), (2, 4, 4, 200, 333, 64, False, f32),
        (b, h, h, s, s, dh, True, f32),
        (1, 2, 2, 128, 128, 64, True, bf16), (2, 8, 2, 200, 200, 224, True, bf16),
        (1, 4, 2, 130, 70, 40, True, bf16), (1, 4, 4, 65, 511, 128, False, bf16),
        (b, h, h, s, s, dh, True, bf16),
    ]
    cases = []
    for bb, hq, hkv, sq, skv, d, causal, dtype in shapes:
        q = _normal(rng, (bb, sq, hq, d), dev, dtype).transpose(1, 2)  # the model's views
        k = _normal(rng, (bb, skv, hkv, d), dev, dtype).transpose(1, 2)
        v = _normal(rng, (bb, skv, hkv, d), dev, dtype).transpose(1, 2)
        out = fa.flash_attention_cuda(q, k, v, causal=causal)
        ref = gqa_attention_plain(q, k, v, causal=causal)
        check(out.dtype == dtype and out.shape == ref.shape, f"B4 output {out.dtype} {tuple(out.shape)}")
        _check_close(f"B4 b={bb} hq={hq} hkv={hkv} sq={sq} skv={skv} dh={d} causal={causal} "
                     f"{str(dtype)[6:]}", out, ref, FLASH_TOL[dtype], cases, errs, "B4")
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    emit({"phase": "flash_kernel", "cases": cases, "tolerance": {"float32": FLASH_TOL[f32],
                                                                "bfloat16": FLASH_TOL[bf16]}})


def _ssd_case(rng, b, h, l, dh, ds, dev, dtype):
    """The reference test's recipe (tests/test_flash_ssd_pallas.py:59)."""
    x = _normal(rng, (b, h, l, dh), dev, dtype)
    dt = torch.nn.functional.softplus(_normal(rng, (b, h, l), dev) - 1.0)
    A = -torch.nn.functional.softplus(_normal(rng, (h,), dev))
    return x, dt, A, _normal(rng, (b, l, ds), dev, dtype), _normal(rng, (b, l, ds), dev, dtype)


def _ssd_model_views(rng, b, h, l, dh, ds, dev):
    """B5's inputs as the Mamba-2 block hands them over: x, B and C slices
    of one (b, l, h·dh + 2·ds) bf16 conv output (x viewed (b, h, l, dh)),
    dt the (b, l, h) projection transposed, A = −(1 … 16)."""
    di = h * dh
    xBC = _normal(rng, (b, l, di + 2 * ds), dev, torch.bfloat16)
    x = xBC[..., :di].reshape(b, l, h, dh).transpose(1, 2)
    dt = torch.nn.functional.softplus(_normal(rng, (b, l, h), dev) - 1.0).transpose(1, 2)
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device=dev)))
    return x, dt, A, xBC[..., di : di + ds], xBC[..., di + ds :]


B5_ROUTES = {"default": False, "cuda cores": True}  # ssd_scan_cuda's _cuda_cores
F64_FACTOR = 2.0  # bf16 B5 at the slice: |kernel − f64| ≤ this × |plain − f64|


def phase_ssd_kernel(rng, errs):
    """B5 against ``ssd_scan_chunked_ref`` and the step recurrence, each
    case on both routes (the default — the tensor cores for aligned bf16
    with dh, ds and the chunk multiples of 16, ``ssd_scan.b5_route`` — and
    the CUDA-core kernel forced): chunks 32/64/128, the reference's shape
    sweep, the slice's shape in bf16 (contiguous and on the model's strided
    views) and one 4,096-step case (32 chunks carry the state); 2e-3 /
    5e-2.  At the slice on the model's views each route lies no further
    from the f64 recurrence than F64_FACTOR × the plain version, and two
    runs of each give the same bits."""
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref, ssd_scan_ref

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [  # (b, h, l, dh, ds, chunk, dtype)
        *[(2, 3, 256, 16, 8, c, f32) for c in (32, 64, 128)],
        (1, 1, 64, 8, 4, 64, f32), (2, 4, 192, 32, 16, 64, f32), (1, 2, 128, 64, 64, 64, f32),
        (2, 3, 128, 16, 8, 64, bf16), (*SSD_SLICE, bf16),
        (1, 4, 4096, 64, 64, 128, f32),
        *[(2, 3, 256, 32, 16, c, bf16) for c in (32, 64, 128)], (1, 4, 4096, 64, 64, 128, bf16),
    ]
    cases, routes = [], []
    for b, h, l, dh, ds, chunk, dtype in shapes:
        x, dt, A, B, C = _ssd_case(rng, b, h, l, dh, ds, dev, dtype)
        chunked = ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk)
        recurrence = ssd_scan_ref(x, dt, A, B, C)
        for route, forced in B5_ROUTES.items():
            key = "B5" if route == "default" else "B5_cuda_cores"
            out = ssd.ssd_scan_cuda(x, dt, A, B, C, chunk=chunk, _cuda_cores=forced)
            check(out.dtype == dtype and out.shape == x.shape, f"B5 output {out.dtype} {tuple(out.shape)}")
            took = "cuda cores" if forced else ssd.b5_route(x, dt, A, B, C, chunk)
            name = f"B5 [{took}] b={b} h={h} l={l} dh={dh} ds={ds} chunk={chunk} {str(dtype)[6:]}"
            routes.append(took)
            _check_close(name + " vs chunked", out, chunked, SSD_TOL[dtype], cases, errs, key)
            _check_close(name + " vs recurrence", out, recurrence, SSD_TOL[dtype], cases, errs,
                         key + "_recurrence")
            del out
        del x, dt, A, B, C, chunked, recurrence
    check("tensor cores" in routes, "no B5 case took the tensor cores")

    # the slice on the model's strided views, against the f64 recurrence
    args = _ssd_model_views(rng, *SSD_SLICE[:5], dev)
    chunk = SSD_SLICE[5]
    check(ssd.b5_route(*args, chunk) == "tensor cores",
          f"the slice's views take {ssd.b5_route(*args, chunk)}")
    exact = ssd_scan_ref(*(t.double() for t in args))
    plain = ssd_scan_chunked_ref(*args, chunk=chunk)
    plain_f64 = _err(plain, exact)
    witness = {"plain_vs_f64": plain_f64, "factor": F64_FACTOR}
    for route, forced in B5_ROUTES.items():
        out = ssd.ssd_scan_cuda(*args, chunk=chunk, _cuda_cores=forced)
        again = ssd.ssd_scan_cuda(*args, chunk=chunk, _cuda_cores=forced)
        torch.cuda.synchronize()
        _check_close(f"B5 [{route}] the slice on the model's views vs chunked", out, plain,
                     SSD_TOL[bf16], cases, errs, "B5" if route == "default" else "B5_cuda_cores")
        witness[route] = {"kernel_vs_f64": _err(out, exact), "bit_identical": torch.equal(out, again)}
        check(witness[route]["bit_identical"], f"B5 [{route}]: two runs differ")
        check(witness[route]["kernel_vs_f64"] <= F64_FACTOR * plain_f64,
              f"B5 [{route}] at the slice: {witness[route]['kernel_vs_f64']:.3e} from f64, more "
              f"than {F64_FACTOR} × the plain version's {plain_f64:.3e}")
        del out, again
    del args, exact, plain
    torch.cuda.empty_cache()
    emit({"phase": "ssd_kernel", "cases": cases, "slice_vs_f64": witness,
          "tolerance": {"float32": SSD_TOL[f32], "bfloat16": SSD_TOL[bf16]}})


def phase_lm_timing(rng):
    """B4 and B5 at the serving slice's shapes and layouts (bf16 views of
    the model's projections) beside the plain versions, the library
    yardstick (B4: scaled_dot_product_attention; B5 has no single PyTorch
    call) and the bound."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref

    dev = torch.device("cuda")
    rows = {}
    b, h, s, dh = ATTN_SLICE
    qkv = _normal(rng, (b, s, 3, h, dh), dev, torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bound_ms, bound_by = flash_bound(b, h, s, s, dh, True, torch.bfloat16)
    rows["B4"] = {"shape": {"b": b, "heads": h, "sq": s, "skv": s, "dh": dh, "causal": True,
                            "dtype": "bfloat16"},
                  "ms": time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True), reps=20),
                  "plain_ms": time_ms(lambda: gqa_attention_plain(q, k, v, causal=True), reps=5),
                  "library_ms": time_ms(lambda: sdpa(q, k, v, is_causal=True), reps=20),
                  "library": "torch.nn.functional.scaled_dot_product_attention (yardstick only)",
                  "bound_ms": bound_ms, "bound_by": bound_by}
    del qkv, q, k, v

    b, h, l, dh, ds, chunk = SSD_SLICE
    x, dt, A, Bm, Cm = _ssd_model_views(rng, b, h, l, dh, ds, dev)
    check(ssd.b5_route(x, dt, A, Bm, Cm, chunk) == "tensor cores", "the timed B5 slice's route")
    bound_ms, bound_by = ssd_bound(b, h, l, dh, ds, chunk, torch.bfloat16)

    def scan(cuda_cores):
        return lambda: ssd.ssd_scan_cuda(x, dt, A, Bm, Cm, chunk=chunk, _cuda_cores=cuda_cores)

    # the two routes in turns: tensor cores, CUDA cores, CUDA cores, tensor cores
    tc_ms, cc_ms = time_ms(scan(False), reps=50), time_ms(scan(True), reps=20)
    cc_ms, tc_ms = (cc_ms + time_ms(scan(True), reps=20)) / 2, (tc_ms + time_ms(scan(False), reps=50)) / 2
    rows["B5"] = {"shape": {"b": b, "heads": h, "l": l, "dh": dh, "ds": ds, "chunk": chunk,
                            "dtype": "bfloat16"},
                  "route": "tensor cores", "ms": tc_ms, "ms_cuda_cores": cc_ms,
                  "plain_ms": time_ms(lambda: ssd_scan_chunked_ref(x, dt, A, Bm, Cm, chunk=chunk),
                                      reps=5),
                  "library_ms": None, "library": "none: no single PyTorch call computes the scan",
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "bound_share_cuda_cores": bound_ms / cc_ms}
    check(tc_ms < cc_ms, f"B5: the tensor-core route ({tc_ms:.4f} ms) is not faster than the "
          f"CUDA-core route ({cc_ms:.4f} ms)")
    del x, Bm, Cm, dt
    torch.cuda.empty_cache()
    for key, row in rows.items():
        row["bound_share"] = row["bound_ms"] / row["ms"]
        emit({"phase": "timing", "kernel": key, **row})
    return rows


def _lm_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    return {"B4": fa.launches, "B5": ssd.launches}


def _reset_lm_counts():
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    fa.reset_launch_counts()
    ssd.reset_launch_counts()


def b4_route(q, k, v):
    """The path B4's entry point takes for these inputs (the dispatch of
    ``flash_attention.cu``): bf16 with a head dim that is a multiple of 16,
    kv rows, and 16-byte aligned bases and strides go to the tensor cores."""
    dh, skv = q.shape[-1], k.shape[2]
    aligned = all(x.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and st * x.element_size() % 16 == 0)
        for n, st in zip(x.shape[:3], x.stride()[:3])) for x in (q, k, v))
    ok = q.dtype == torch.bfloat16 and dh % 16 == 0 and skv > 0 and aligned
    return "tensor cores" if ok else "cuda cores"


@contextlib.contextmanager
def shadowed_kernels(witness=False):
    """While open, every B4 / B5 call the model makes on the kernel path
    (through ``attention.flash_attention`` / ``ssm.ssd_scan``, the names
    the model calls) also runs the kernel's plain version on the same
    inputs, and with ``witness`` the plain version in f64 (B5: the step
    recurrence).  Yields {kernel: [per call: "rel", max |kernel − plain| /
    max |plain|; with the witness "kernel_f64" and "plain_f64", the max
    |Δ| of each from f64]}."""
    from repro_torch.kernels.flash_attention.ref import gqa_attention_plain
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_chunked_ref, ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ssd_scan import b5_route
    from repro_torch.models import attention, ssm

    calls = {"B4": [], "B5": []}
    flash, scan = attention.flash_attention, ssm.ssd_scan

    def record(key, out, plain, exact_fn, args):
        rec = {"rel": rel_err(out.float(), plain.float())[1]}
        if witness:
            exact = exact_fn(*(t.double() for t in args))
            rec["kernel_f64"], rec["plain_f64"] = _err(out, exact), _err(plain, exact)
        calls[key].append(rec)

    def flash_shadow(q, k, v, *, causal=True):
        out = flash(q, k, v, causal=causal)
        record("B4", out, gqa_attention_plain(q, k, v, causal=causal),
               lambda *t: gqa_attention_plain(*t, causal=causal), (q, k, v))
        calls["B4"][-1]["route"] = b4_route(q, k, v)
        return out

    def scan_shadow(x, dt, A, B, C, *, chunk=128, use_kernel=True):
        out = scan(x, dt, A, B, C, chunk=chunk, use_kernel=use_kernel)
        if use_kernel:
            record("B5", out, ssd_scan_chunked_ref(x, dt, A, B, C, chunk=chunk),
                   ssd_scan_ref, (x, dt, A, B, C))
            calls["B5"][-1]["route"] = b5_route(x, dt, A, B, C, chunk)
        return out

    attention.flash_attention, ssm.ssd_scan = flash_shadow, scan_shadow
    try:
        yield calls
    finally:
        attention.flash_attention, ssm.ssd_scan = flash, scan


def _to_f64(params):
    """Every leaf of the parameter tree replaced in place by its f64 copy,
    the largest first, so that the f32 and f64 trees never coexist."""
    slots = []

    def walk(tree):
        for key, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            else:
                slots.append((tree, key))

    walk(params)
    for tree, key in sorted(slots, key=lambda s: -s[0][s[1]].numel()):
        tree[key] = tree[key].double()
    return params


def phase_lm_parity(seed, layers, *, tol, decode):
    """zamba2-7b at full width with depth cut to ``layers``, in f32, batch
    2, a 256-token prompt: the forward with B4/B5 against the same forward
    with their plain versions (within ``tol`` where given) and both against
    the f64 witness, the plain forward on the same parameters in f64: the
    kernel forward's logits, and each of its B4 / B5 calls beside the
    call's plain version in f64, no further from f64 than WITNESS_FACTOR ×
    the f32 plain ones; with ``decode``, the forward against the logits of
    decode stepped over the prompt at every position (2e-2)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, hybrid

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("zamba2-7b"), num_layers=layers, dtype="float32")
    P, G, tail = hybrid._group_shape(cfg)
    bundle = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = bundle.init(gen)
    tok = torch.randint(0, cfg.vocab_size, (PARITY_BATCH, PARITY_PROMPT), generator=gen, device=dev)
    result = {"phase": "lm_parity", "layers": cfg.num_layers, "groups": [G, P, tail],
              "dtype": "float32", "batch": PARITY_BATCH, "prompt": PARITY_PROMPT}
    with torch.inference_mode():
        _reset_lm_counts()
        with shadowed_kernels(witness=True) as calls:
            kern = hybrid.forward(params, cfg, tok)
        torch.cuda.synchronize()
        counts = _lm_counts()
        plain = hybrid.forward(params, cfg, tok, use_kernels=False)
        torch.cuda.synchronize()
        check(_lm_counts() == counts, f"the plain forward launched a kernel: {_lm_counts()}")
        check(counts == {"B4": G, "B5": cfg.num_layers},
              f"forward launches {counts} != B4 {G}, B5 {cfg.num_layers}")
        if decode:
            cache = bundle.init_cache(params, PARITY_BATCH, PARITY_PROMPT)
            steps = []
            for t in range(PARITY_PROMPT):
                lg, cache = bundle.decode(params, tok[:, t], cache,
                                          torch.full((PARITY_BATCH,), t, device=dev))
                steps.append(lg)
            dec = torch.stack(steps, dim=1)
            d_abs, d_rel = rel_err(dec, kern)
            result["decode_vs_forward"] = {"max_abs_err": d_abs, "rel_err": d_rel, "tol": DECODE_TOL}
            del cache, steps
        exact = hybrid.forward(_to_f64(params), cfg, tok, use_kernels=False)
        check(exact.dtype == torch.float64, f"the witness forward ran in {exact.dtype}")
    k_abs, k_rel = rel_err(kern, plain)
    kern_f64, plain_f64 = _err(kern, exact), _err(plain, exact)
    witness = {key: {**{f: max(c[f] for c in recs) for f in ("rel", "kernel_f64", "plain_f64")},
                     "kernel_over_plain_f64": max(c["kernel_f64"] / c["plain_f64"] for c in recs)}
               for key, recs in calls.items()}
    result.update({"launches": counts, "max_abs_logit": float(plain.abs().max()),
                   "kernel_vs_plain": {"max_abs_err": k_abs, "rel_err": k_rel, "tol": tol},
                   "logits_from_f64": {"kernel": kern_f64, "plain": plain_f64},
                   "per_call_max": witness, "witness_factor": WITNESS_FACTOR})
    emit(result)
    check(bool(torch.isfinite(kern).all()), "non-finite logits")
    if tol is not None:
        check(_within(kern, plain, tol), f"forward kernel vs plain: max |Δ| {k_abs:.3e}")
    check(kern_f64 <= WITNESS_FACTOR * plain_f64,
          f"logits: the kernel forward {kern_f64:.3e} from f64, the plain one {plain_f64:.3e}")
    check(len(calls["B5"]) == cfg.num_layers and len(calls["B4"]) == G,
          f"witnessed {len(calls['B5'])} B5 and {len(calls['B4'])} B4 calls")
    for key, recs in calls.items():
        for i, c in enumerate(recs):
            check(c["kernel_f64"] <= WITNESS_FACTOR * c["plain_f64"],
                  f"{key} call {i}: {c['kernel_f64']:.3e} from f64, the plain version "
                  f"{c['plain_f64']:.3e}")
    if decode:
        check(bool(torch.isfinite(dec).all()), "non-finite decode logits")
        check(_within(dec, kern, DECODE_TOL), f"decode vs forward: max |Δ| {d_abs:.3e}")
        del dec
    del params, kern, plain, exact
    torch.cuda.empty_cache()


def profile_lm(fn, top=8):
    """Device time of one call of ``fn`` by kernel (torch.profiler): the
    largest ``top`` entries, the rest summed, the wall time and the
    device's busy and idle shares of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda kv: -kv[1],
    )
    busy = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
            "kernel_launches": sum(n for _, _, n in kernels),
            "top": [{"kernel": name[:70], "ms": ms, "calls": n} for name, ms, n in kernels[:top]],
            "other_ms": sum(ms for _, ms, _ in kernels[top:])}


def phase_lm_serve(seed):
    """zamba2-7b at full size (81 layers, bf16, weights from the seed on the
    card): one make_prefill_step call over 4 × 512-token prompts (the main
    path, counted: 81 B5 and 13 B4 launches), then the reference's serve
    loop (decode stepped over each prompt, 32 greedy tokens), timed; one
    more kernel forward with every B4 / B5 call held to its plain version
    on the model's own inputs (5e-2 of the plain output's largest entry);
    its logits against the plain forward's, within ROUNDING_FACTOR × the
    plain path's own distance under a one-ulp scaling of its embedding (at
    random weights the 81-layer bf16 model amplifies rounding: PERF.md
    §6); a profile of one prefill and one decode step."""
    from repro_torch.launch.serve import build_server, make_prompts, serve_loop
    from repro_torch.models import hybrid, make_prefill_step

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, bundle, params = build_server("zamba2-7b", "full", seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in _leaves(params))
    param_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    P, G, tail = hybrid._group_shape(cfg)
    prompts = make_prompts(cfg, LM_BATCH, LM_PROMPT, seed=seed, device=dev)
    batch = {"tokens": prompts}
    prefill_step = make_prefill_step(bundle, LM_CACHE)

    with torch.inference_mode():
        # the main path, counted from 0
        _reset_lm_counts()
        (next_tok, cache), prefill_ms, prefill_dev_ms = timed(lambda: prefill_step(params, batch))
        counts = _lm_counts()
        warm = [timed(lambda: prefill_step(params, batch))[1:] for _ in range(3)]
        check(counts == {"B4": G, "B5": cfg.num_layers},
              f"prefill launches {counts} != B4 {G}, B5 {cfg.num_layers}")
        check(next_tok.shape == (LM_BATCH,) and bool(((next_tok >= 0) & (next_tok < cfg.vocab_size)).all()),
              f"prefill tokens {next_tok.tolist()}")
        check(not any(bool(x.any()) for x in _leaves(cache)), "the prefill's cache is not empty")
        del cache

        # the serve loop: decode stepped over each prompt, then greedy steps
        step_ms = {"prefill": [], "decode": []}
        finite = [True]
        clock = [0.0]

        def on_step(phase, t, out):
            torch.cuda.synchronize()
            now = time.perf_counter()
            step_ms[phase].append((now - clock[0]) * 1e3)
            if phase == "prefill":
                finite[0] &= bool(torch.isfinite(out).all())
            clock[0] = time.perf_counter()

        _reset_lm_counts()
        torch.cuda.synchronize()
        clock[0] = t_loop = time.perf_counter()
        generated = serve_loop(bundle, params, prompts, LM_GEN, LM_CACHE, on_step=on_step)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t_loop
        loop_counts = _lm_counts()
        peak = torch.cuda.max_memory_allocated()
        check(finite[0], "non-finite logits in the decode-stepped prefill")
        check(generated.shape == (LM_BATCH, LM_GEN)
              and bool(((generated >= 0) & (generated < cfg.vocab_size)).all()),
              "generated tokens out of range")
        check(loop_counts == {"B4": 0, "B5": 0}, f"decode launched a kernel: {loop_counts}")

        # every B4 / B5 call of a full-depth kernel forward held to its plain
        # version on the model's own inputs; the logits beside the plain
        # path's, and beside the plain path's under its embedding scaled by
        # 1 + 2⁻⁸ (one bf16 ulp): how far rounding alone carries them
        with shadowed_kernels() as in_situ:
            fk = hybrid.forward(params, cfg, prompts).float()
        fp = hybrid.forward(params, cfg, prompts, use_kernels=False).float()
        table = params["embed"]["table"]
        nudged = {**params, "embed": {"table": (table.float() * (1 + 2.0**-8)).to(table.dtype)}}
        fn = hybrid.forward(nudged, cfg, prompts, use_kernels=False).float()
        check(bool(torch.isfinite(fk).all()), "non-finite prefill logits")
        agreement, self_sensitivity = rel_err(fk, fp), rel_err(fn, fp)
        del nudged, fk, fp, fn

        _reset_lm_counts()
        prof_prefill = profile_lm(lambda: prefill_step(params, batch))
        cache = bundle.init_cache(params, LM_BATCH, LM_CACHE)
        pos = torch.full((LM_BATCH,), LM_PROMPT - 1, device=dev)
        bundle.decode(params, prompts[:, -1], cache, pos)
        prof_decode = profile_lm(lambda: bundle.decode(params, prompts[:, -1], cache, pos))
        del cache

    decode = step_ms["decode"]
    warm_ms = [w[0] for w in warm]
    result = {
        "phase": "lm_serve", "arch": "zamba2-7b", "layers": cfg.num_layers, "groups": [G, P, tail],
        "dtype": cfg.dtype, "params": n_params, "param_bytes": param_bytes,
        "init_s": init_s, "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
        "cache_len": LM_CACHE, "launches": counts,
        "prefill_ms": prefill_ms, "prefill_device_ms": prefill_dev_ms, "prefill_warm_ms": warm_ms,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / (min(warm_ms) / 1e3),
        "stepped_prefill_ms_per_step": sum(step_ms["prefill"]) / len(step_ms["prefill"]),
        "decode_ms_per_token": sum(decode) / len(decode),
        "decode_ms_first_last": [decode[0], decode[-1]],
        "decode_tokens_per_s": LM_BATCH * len(decode) / (sum(decode) / 1e3),
        "serve_loop_s": loop_s, "peak_device_bytes": peak,
        "generated_sample": generated[0, :16].tolist(),
        "kernel_vs_plain_logits": agreement,
        "plain_vs_plain_one_ulp_embedding": self_sensitivity,
        "allow_bf16_reduced_precision_reduction":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
        "in_situ_kernel_vs_plain": {k: {"calls": len(v), "max_rel": max(c["rel"] for c in v),
                                        "bound": LM_REL_BOUND} for k, v in in_situ.items()},
        "b4_routes": sorted({c["route"] for c in in_situ["B4"]}),
        "b5_routes": {r: sum(c["route"] == r for c in in_situ["B5"])
                      for r in sorted({c["route"] for c in in_situ["B5"]})},
        "profile": {"prefill": prof_prefill, "decode_step": prof_decode},
    }
    emit(result)
    check(len(in_situ["B5"]) == cfg.num_layers and len(in_situ["B4"]) == G,
          f"in situ: {len(in_situ['B5'])} B5 and {len(in_situ['B4'])} B4 calls")
    check(result["b4_routes"] == ["tensor cores"],
          f"the bf16 prefill's B4 calls took {result['b4_routes']}")
    check(result["b5_routes"] == {"tensor cores": cfg.num_layers},
          f"the bf16 prefill's B5 calls took {result['b5_routes']}")
    for key, recs in in_situ.items():
        worst = max(c["rel"] for c in recs)
        check(worst <= LM_REL_BOUND,
              f"in situ {key} vs plain: max |Δ| / max |plain| {worst:.3e} > {LM_REL_BOUND}")
    check(agreement[1] <= ROUNDING_FACTOR * self_sensitivity[1],
          f"full-depth logits: kernel vs plain {agreement[1]:.3e} of the largest logit, more "
          f"than {ROUNDING_FACTOR} × the one-ulp distance {self_sensitivity[1]:.3e}")
    del params
    torch.cuda.empty_cache()
    return result


# --------------------------------------------------------------------------
# streaming serving, health and telemetry (gp_serve at the kin40k shape)
# --------------------------------------------------------------------------

#: the card's name and power limit (nvidia-smi), printed beside every phase
CARD = ""
STREAM_D = 8
STREAM_BATCH = 1024
STREAM_REQUESTS = 48
OBSERVE_EVERY = 8
OBSERVE_BATCH = 64
STREAM_STALENESS = 4
STREAM_CG_ITERS = 25
#: the build's (8 + 1)·(25 + 1) = 234 Krylov columns plus ≤ 26 an append
#: pass this, so every append runs the Rayleigh–Ritz compaction
STREAM_BASIS = 256
#: an appended α's true relative residual against a full rebuild's at the
#: same data and the same 25 iterations: at most this factor of the larger
#: of the rebuild's and cg_tol (both solves aim at cg_tol; where one
#: stopped there, f32 CG's recursive residual may undershoot its true one)
APPEND_RES_FACTOR = 2.0
THREADS = 4
#: every query, refresh and driver thread of these phases joins within this
JOIN_TIMEOUT_S = 300.0
#: the ladder's f32 rungs at n = 40,000 (one column, rank 0) reach cg_tol =
#: 1e-4 within this many iterations on the card (residual 1.6e-3 at 100)
LADDER_CG_ITERS = 200
LADDER_DENSE_N = 2048
#: a healed answer's true relative residual (f64) at most this: cg_tol
#: plus the drift of f32 CG's recursive residual from its true one
LADDER_TRUE_RES = 1e-3
#: the chaos drill's iteration budget: its clean build (mixed, rank 5, 8
#: probes) at n = 40,000 converges at iteration 198 on the card (worst
#: column 0.53 at the reference drill's 40, 1.2e-3 at 150); 220 leaves
#: 10 % headroom
CHAOS_CG_ITERS = 220


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _stream_queries(seed, count, rows=256):
    from repro_torch.launch import gp_serve

    return [torch.from_numpy(gp_serve._query_batch(seed, 10_000 + i, rows, STREAM_D)).cuda()
            for i in range(count)]


def _true_rel_residual(kern, noise, X, y, alpha, rows=4096):
    """‖y − K̂α‖/‖y‖ in f64, K̂ formed a row block at a time."""
    X64, a64, y64 = X.double(), alpha.double(), y.double()
    r = torch.empty_like(y64)
    for i in range(0, X.shape[0], rows):
        Kb = kern(X64[i : i + rows], X64)
        r[i : i + rows] = y64[i : i + rows] - Kb @ a64 - noise * a64[i : i + rows]
    return float(r.norm() / y64.norm())


def _rbf64(gp, params):
    from repro_torch.gp import RBFKernel

    kern = gp.kernel(params)
    return RBFKernel(lengthscale=kern.lengthscale.double(),
                     outputscale=kern.outputscale.double()), float(gp.noise(params))


def _convergence(seed, n, iters, **model_kw):
    """The gp_serve system's solve health by iteration budget: one cache
    build (``cache=True``, the worst of its 9 columns) or one solve of y
    per budget — status, relative residual, iterations used."""
    import warnings

    from repro_torch.core import SolveHealthWarning, collect, solve
    from repro_torch.launch import gp_serve

    X, y = gp_serve._toy(seed, n, STREAM_D)
    Xd, yd = torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()
    cache = model_kw.pop("cache", False)
    rows = []
    for p in iters:
        gp = gp_serve.build_model("exact", max_cg_iters=p, **model_kw)
        params = gp.init_params(X)
        with warnings.catch_warnings(), collect() as reports:
            warnings.simplefilter("ignore", SolveHealthWarning)
            if cache:
                gp.posterior_cache(params, Xd, yd)
            else:
                solve(gp.operator(params, Xd), yd, gp.settings)
        r = reports[-1]
        rows.append({"max_cg_iters": p, "status": r.status, "residual": r.residual_norm,
                     "iters": r.num_iters})
    return rows


def phase_gp_stream(km, seed, n):
    """The sequential driver (``gp_serve.run_serve``) at n = 40,000: 48
    1,024-point requests, 64 observations every 8, ``max_staleness=4`` (both
    appends and forced rebuilds), ``max_basis_columns=256`` (an append of
    26 new directions to the build's 234 compacts).  Gates: every append launched f32 B1 (the residual, one per
    CG iteration, the new columns: p + 2) and nothing else; every appended
    cache's variance conservative against the exact f64 posterior at its
    data; every appended α's true residual within APPEND_RES_FACTOR of a
    full rebuild's at the same data and budget."""
    import warnings

    from repro_torch.core import SolveHealthWarning
    from repro_torch.launch import gp_serve

    p = STREAM_CG_ITERS
    state, observes = {}, []
    # y's one-column solve on this system (rank 5, "highest") by budget
    convergence = _convergence(seed, n, (p, 100))

    def on_session(session):
        state["session"] = session
        state["build_iters"] = int(session.cache.cg_iters.max())
        state["mark"] = km.launch_counts()

    def on_observe(session, r, path, seconds):
        now = km.launch_counts()
        observes.append({"r": r, "path": path, "ms": seconds * 1e3, "n": session.n,
                         "launches": _delta(now, state["mark"]),
                         "cg_iters": int(session.cache.cg_iters.max()),
                         "basis": int(session.cache.basis.shape[1]), "cache": session.cache})
        state["mark"] = now

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", SolveHealthWarning)  # 25 iterations: MAX_ITERS
        km.reset_launch_counts()
        metrics = gp_serve.run_serve(
            model="exact", n=n, d=STREAM_D, requests=STREAM_REQUESTS, batch=STREAM_BATCH,
            observe_every=OBSERVE_EVERY, observe_batch=OBSERVE_BATCH,
            max_staleness=STREAM_STALENESS, max_cg_iters=p, max_basis_columns=STREAM_BASIS,
            seed=seed, session_hook=on_session, observe_hook=on_observe)
        totals = km.launch_counts()
    session = state["session"]
    appends = [o for o in observes if o["path"] == "append"]
    rebuilds = [o for o in observes if o["path"] == "rebuild"]
    check(len(appends) >= 1 and len(rebuilds) >= 1,
          f"{len(appends)} appends and {len(rebuilds)} rebuilds: the workload needs both")
    only_b1 = lambda d, k: d["launches"] == k and sum(d.values()) == k  # noqa: E731
    for o in appends:
        check(only_b1(o["launches"], p + 2),
              f"append at r={o['r']} launched {o['launches']}, not {p + 2} f32 B1")
        check(o["basis"] <= STREAM_BASIS, f"append at r={o['r']}: basis {o['basis']} columns "
              f"past max_basis_columns = {STREAM_BASIS}")
    check(any(o["basis"] == STREAM_BASIS for o in appends),
          f"no append was compacted to {STREAM_BASIS} columns")
    for o in rebuilds:
        check(only_b1(o["launches"], p + 1), f"rebuild at r={o['r']} launched {o['launches']}")

    gp, params = session.model, session.params
    kern64, noise = _rbf64(gp, params)
    kern = gp.kernel(params)
    queries = _stream_queries(seed, 1)
    rows = []
    for o in appends:
        m = o["n"]
        Xi, yi = session.X[:m], session.y[:m]
        cache = o["cache"]
        (_, exact_var), = exact_posterior(Xi, yi, queries, float(kern.lengthscale),
                                          float(kern.outputscale), noise, kernel="rbf")
        _, var = gp.predict_cached(params, Xi, cache, queries[0])
        under = float((exact_var - var.double()).max())
        rebuilt = gp.posterior_cache(params, Xi, yi)
        res_app = _true_rel_residual(kern64, noise, Xi, yi, cache.alpha)
        res_reb = _true_rel_residual(kern64, noise, Xi, yi, rebuilt.alpha)
        rows.append({"r": o["r"], "n": m, "var_max_undershoot": under,
                     "alpha_true_res": res_app, "rebuild_true_res": res_reb,
                     "append_cg_iters": o["cg_iters"], "append_ms": o["ms"]})
        check(under <= 1e-3, f"append at n={m}: cached variance undershoots the exact one "
              f"by {under:.3e}")
        check(res_app <= APPEND_RES_FACTOR * max(res_reb, gp.settings.cg_tol),
              f"append at n={m}: true residual {res_app:.3e} vs a rebuild's {res_reb:.3e}")
        del rebuilt
        torch.cuda.empty_cache()
    statuses = {}
    for r in session.health_reports:
        statuses.setdefault(r.context, []).append(r.status)
    emit({"phase": "gp_stream", "card": CARD, "n": n, "final_n": metrics["final_n"],
          "requests": STREAM_REQUESTS, "batch": STREAM_BATCH,
          "cached_points_per_s": metrics["cached_qps"], "ms_per_request": metrics["query_ms"],
          "append_ms_min": metrics["append_s"] * 1e3, "append_ms_mean": metrics["append_avg_s"] * 1e3,
          "observe_rebuild_ms": [o["ms"] for o in rebuilds],
          "rebuild_ms": metrics["rebuild_s"] * 1e3, "cache_build_ms": metrics["cache_build_s"] * 1e3,
          "append_speedup": metrics["append_speedup"],
          "cg_iters_build": state["build_iters"],
          "cg_iters_appends": [o["cg_iters"] for o in appends],
          "launches_by_observe": [{"r": o["r"], "path": o["path"], **o["launches"]} for o in observes],
          "launches": totals, "appends": rows, "statuses": statuses,
          "y_solve_by_budget": convergence})
    return {"B1": totals["launches"], "B1_bf16": totals["bf16_launches"]}


@contextlib.contextmanager
def per_call_launches(calls):
    """Patch ExactGP's cache builds, appends and cached predictions to
    record, per call, the launches its own thread made during it
    (``km.thread_launch_counts``), into ``calls``: (method, counts)."""
    import threading

    from repro_torch.gp.model import KrylovCachePredictor
    from repro_torch.kernels.kernel_matmul import kernel_matmul as km

    lock = threading.Lock()
    names = ("posterior_cache", "update_cache", "predict_cached")
    saved = {nm: getattr(KrylovCachePredictor, nm) for nm in names}

    def wrap(nm, fn):
        def counted(self, *a, **kw):
            before = km.thread_launch_counts()
            try:
                return fn(self, *a, **kw)
            finally:
                d = _delta(km.thread_launch_counts(), before)
                with lock:
                    calls.append((nm, d))
        return counted

    for nm, fn in saved.items():
        setattr(KrylovCachePredictor, nm, wrap(nm, fn))
    try:
        yield calls
    finally:
        for nm, fn in saved.items():
            setattr(KrylovCachePredictor, nm, fn)


def phase_gp_threaded(km, seed, n):
    """``gp_serve.run_serve_threaded`` at n = 40,000 with 4 query workers
    and the double-buffered refreshes on the refresher worker, the
    gp_stream workload.  Gates: no query raised; every refresh swapped or
    discarded (counted) and at least one discarded; each served answer
    equal, bit for bit, to the same query answered afterwards from the
    state it reports (one cache object per version); the launch counters'
    totals equal the sum of what each call launched on its own thread."""
    import threading
    import warnings

    from repro_torch.core import SolveHealthWarning
    from repro_torch.launch import gp_serve

    served, calls, lock, state = [], [], threading.Lock(), {}

    def on_query(r, Xq, answer, s):
        with lock:
            served.append((r, Xq, answer, s))

    with warnings.catch_warnings(), per_call_launches(calls):
        warnings.simplefilter("ignore", SolveHealthWarning)
        km.reset_launch_counts()
        metrics = gp_serve.run_serve_threaded(
            model="exact", n=n, d=STREAM_D, requests=STREAM_REQUESTS, batch=STREAM_BATCH,
            observe_every=OBSERVE_EVERY, observe_batch=OBSERVE_BATCH,
            max_staleness=STREAM_STALENESS, max_cg_iters=STREAM_CG_ITERS,
            max_basis_columns=STREAM_BASIS, threads=THREADS, seed=seed,
            session_hook=lambda s: state.setdefault("session", s), query_hook=on_query,
            timeout_s=JOIN_TIMEOUT_S)
        totals = km.launch_counts()
    check(len(served) == STREAM_REQUESTS, f"{len(served)} of {STREAM_REQUESTS} queries answered")
    refreshes = metrics["async_refreshes_swapped"] + metrics["async_refreshes_discarded"]
    appends = sum(1 for nm, _ in calls if nm == "update_cache")
    check(refreshes == appends, f"{refreshes} refreshes for {appends} appends")
    check(metrics["async_refreshes_discarded"] >= 1, "no stale buffer was discarded")
    summed = {k: sum(d[k] for _, d in calls) for k in totals}
    check(summed == totals, f"launch counters {totals} != the calls' sum {summed}")
    check(all(sum(d.values()) == 0 for nm, d in calls if nm == "predict_cached"),
          "a cached prediction launched a kernel")
    gp = state["session"].model
    caches = {}
    for r, Xq, (mean, var), s in served:
        caches.setdefault(s.info.version, set()).add(id(s.cache))
        again = gp.predict_cached(s.params, s.data, s.cache, Xq)
        check(torch.equal(again[0], mean) and torch.equal(again[1], var),
              f"query {r} does not replay bit for bit from cache v{s.info.version}")
    check(all(len(ids) == 1 for ids in caches.values()), "two caches under one version")
    emit({"phase": "gp_threaded", "card": CARD, "n": n, "threads": THREADS,
          "concurrent_points_per_s": metrics["concurrent_qps"],
          "query_ms_p50": metrics["query_ms_p50"],
          "refreshes_swapped": metrics["async_refreshes_swapped"],
          "refreshes_discarded": metrics["async_refreshes_discarded"],
          "versions_served": sorted(caches), "final_version": metrics["cache_version"],
          "calls": {nm: sum(1 for c, _ in calls if c == nm) for nm in
                    ("posterior_cache", "update_cache", "predict_cached")},
          "launches": totals})
    return {"B1": totals["launches"], "B1_bf16": totals["bf16_launches"]}


def _rung_launches(col):
    """Launches by counter inside each ``rung:*`` span of a trace (the
    kernel wrappers' ``launch`` markers on the span's thread)."""
    marks = col.instants("launch")
    out = []
    for span in col.spans():
        if not span["name"].startswith("rung:"):
            continue
        lo, hi = span["ts"], span["ts"] + span["dur"]
        counts = {}
        for m in marks:
            if m["tid"] == span["tid"] and lo <= m["ts"] <= hi:
                key = m["args"]["counter"]
                counts[key] = counts.get(key, 0) + m["args"]["count"]
        out.append((span["name"][5:], counts))
    return out


def phase_gp_ladder(km, seed, n):
    """The degradation ladder on the card: ``solve`` of the gp_serve system
    (RBF, ℓ = 0.5, s = 1, σ² = 0.1) through a FaultInjectingOperator, each
    scenario's rung sequence, statuses and launches by kernel and dtype
    inside each rung (from the trace's launch markers) against what the
    settings call for."""
    import warnings

    from repro_torch import obs
    from repro_torch.core import (
        BBMMSettings,
        FaultSchedule,
        SolveHealthWarning,
        collect,
        health,
        solve,
    )
    from repro_torch.launch import gp_serve

    X, y = gp_serve._toy(seed, n, STREAM_D)
    gp = gp_serve.build_model("exact")
    params = gp.init_params(X)
    Xd, yd = torch.from_numpy(X).cuda(), torch.from_numpy(y).cuda()
    p = LADDER_CG_ITERS
    base = dict(num_probes=8, max_cg_iters=p, precond_rank=0, on_failure="degrade")
    C, D = health.CONVERGED, health.NON_FINITE
    scenarios = [
        # name, rows, schedule, settings, [(rung, status or None, launches)]
        ("mixed_fused_precision_f32", n, dict(nan_rate=1.0, reduced_only=True),
         dict(base, precision="mixed", fuse_cg=True),
         # the initial rung's f32 refreshes: ⌊p/2⌋ in the loop and a final one
         [("initial", "unhealthy", {"bf16_fused_launches": p, "launches": p // 2 + 1}),
          ("precision_f32", C, {"fused_launches": p})]),
        ("f32_fused_unfused", n, dict(nan_calls=(2,)), dict(base, fuse_cg=True),
         [("initial", D, {"fused_launches": p}), ("unfused", C, {"launches": p})]),
        ("extend_budget", n, dict(nan_calls=(1,)), dict(base),
         [("initial", D, {"launches": p}), ("extend_budget", C, {"launches": 2 * p})]),
        ("dense_cholesky", LADDER_DENSE_N, dict(nan_rate=1.0), dict(base, max_cg_iters=4),
         [("initial", D, {"launches": 4}), ("extend_budget", D, {"launches": 8}),
          ("dense_cholesky", C, {"launches": 1})]),
        ("dense_direct", LADDER_DENSE_N, dict(), dict(base, dense_direct_max_n=LADDER_DENSE_N),
         [("dense_direct", C, {"launches": 1})]),
    ]
    rows = []
    b1 = b1_bf16 = b3 = b3_bf16 = 0
    for name, rows_n, sched_kw, settings, expect in scenarios:
        schedule = FaultSchedule(seed, **sched_kw)
        op = gp_serve._inject_operator(gp.operator(params, Xd[:rows_n]), schedule)
        with warnings.catch_warnings(), collect() as reports, obs.trace() as col:
            warnings.simplefilter("ignore", SolveHealthWarning)
            km.reset_launch_counts()
            x = solve(op, yd[:rows_n], BBMMSettings(**settings))
            torch.cuda.synchronize()
            totals = km.launch_counts()
        report = reports[-1]
        got = _rung_launches(col)
        trail = [(r.rung, r.status) for r in report.rungs]
        kern64, noise = _rbf64(gp, params)
        res = _true_rel_residual(kern64, noise, Xd[:rows_n], yd[:rows_n], x)
        rows.append({"scenario": name, "n": int(Xd[:rows_n].shape[0]), "trail": trail, "residual": res,
                     "rung_ms": [r.duration_s * 1e3 for r in report.rungs],
                     "rung_launches": got, "injected": len(schedule.injected),
                     "schedule_calls": schedule.calls})
        check([r for r, _ in trail] == [r for r, _, _ in expect] == [g for g, _ in got],
              f"ladder {name}: rungs {trail}, spans {[g for g, _ in got]}")
        for (rung, status), (_, want, launches), (_, counts) in zip(trail, expect, got):
            ok = status != C if want == "unhealthy" else status == want
            check(ok, f"ladder {name}: rung {rung} is {status}, expected {want}")
            check(counts == launches, f"ladder {name}: rung {rung} launched {counts}, "
                  f"expected {launches}")
        check(report.status == C and res <= LADDER_TRUE_RES,
              f"ladder {name}: healed to {report.status}, true residual {res:.3e}")
        b1 += totals["launches"]
        b1_bf16 += totals["bf16_launches"]
        b3 += totals["fused_launches"]
        b3_bf16 += totals["bf16_fused_launches"]
    emit({"phase": "gp_ladder", "card": CARD, "max_cg_iters": p, "scenarios": rows})
    return {"B1": b1, "B1_bf16": b1_bf16, "B3": b3, "B3_bf16": b3_bf16}


def phase_gp_chaos(km, seed, n):
    """``gp_serve.run_serve_chaos`` at n = 40,000 (mixed, ``on_failure=
    "degrade"``, 2 query threads, CHAOS_CG_ITERS): gated on ``chaos_ok``
    (≥ 1 precision_f32 escalation, ≥ 1 degraded query, 0 raised queries,
    the breaker opened and re-closed) and on a CONVERGED clean build; the
    bf16 B1 launches and the faults injected into them recorded."""
    from repro_torch.core import health
    from repro_torch.launch import gp_serve

    # the drill's clean build (mixed, rank 5, 8 probes) by budget: the
    # reference's 40 and upward, to the budget the drill runs at
    convergence = _convergence(seed, n, (40, 60, 150, CHAOS_CG_ITERS), precision="mixed",
                               cache=True)
    km.reset_launch_counts()
    metrics, host_ms, _ = timed(lambda: gp_serve.run_serve_chaos(
        n=n, d=STREAM_D, batch=STREAM_BATCH, threads=2, max_cg_iters=CHAOS_CG_ITERS,
        seed=seed, timeout_s=JOIN_TIMEOUT_S))
    totals = km.launch_counts()
    C = health.CONVERGED
    emit({"phase": "gp_chaos", "card": CARD, "n": n, "max_cg_iters": CHAOS_CG_ITERS,
          "ms": host_ms, **metrics, "launches": totals, "clean_build_by_budget": convergence})
    check(metrics["clean_build_status"] == [C],
          f"the drill's clean build is {metrics['clean_build_status']}, not CONVERGED: raise "
          "CHAOS_CG_ITERS")
    check(metrics["chaos_ok"], f"chaos drill failed: {metrics}")
    check(totals["bf16_launches"] >= metrics["fault_injected_bf16"] >= 1,
          "no fault landed on a bf16 B1 launch")
    return {"B1": totals["launches"], "B1_bf16": totals["bf16_launches"]}


def phase_gp_metrics(km, seed, n):
    """The chaos drill again through ``gp_serve.main`` with ``--metrics-port
    0`` on a thread, ``/metrics`` and ``/health`` scraped while it runs and
    in its hold window, parsed with ``obs.parse_prometheus`` and rendered
    with ``gp_top``.  Gates: the escalation, degraded-query and mbcg
    counters present and non-zero; the run's own exit status."""
    import threading
    import urllib.request

    from repro_torch import obs
    from repro_torch.launch import gp_serve, gp_top

    url, result = [], {}

    def run():
        try:
            result["metrics"] = gp_serve.main(
                ["--chaos", "--metrics-port", "0", "--metrics-hold", "2", "--n", str(n),
                 "--d", str(STREAM_D), "--batch", str(STREAM_BATCH), "--threads", "2",
                 "--max-cg-iters", str(CHAOS_CG_ITERS), "--seed", str(seed)],
                on_metrics_server=lambda srv: url.append(srv.url))
        except BaseException as e:  # noqa: BLE001 — reported below (sys.exit too)
            result["error"] = repr(e)

    def get(path):
        with urllib.request.urlopen(url[0] + path, timeout=10) as resp:
            return resp.read().decode()

    km.reset_launch_counts()
    worker = threading.Thread(target=run, name="gp_serve-metrics")
    worker.start()
    scrapes, last = 0, {}
    t0 = time.perf_counter()
    try:
        while worker.is_alive() and time.perf_counter() - t0 < JOIN_TIMEOUT_S:
            if url:
                try:
                    last = {"metrics": get("/metrics"), "health": get("/health")}
                    scrapes += 1
                except OSError:
                    pass
            time.sleep(0.25)
        worker.join(timeout=JOIN_TIMEOUT_S)
    finally:
        obs.uninstall()  # main() installed the process registry
    totals = km.launch_counts()
    check(not worker.is_alive(), "gp_serve --metrics-port did not finish in time")
    check("error" not in result, f"gp_serve --chaos --metrics-port failed: {result.get('error')}")
    check(bool(last), "no scrape of /metrics and /health succeeded")
    fams = obs.parse_prometheus(last["metrics"])
    health_json = json.loads(last["health"])

    def total(name, **match):
        return sum(v for lab, v in fams.get(name, {"samples": []})["samples"]
                   if all(lab.get(k) == w for k, w in match.items()))

    got = {"escalations": total("ladder_rungs_total", rung="precision_f32"),
           "degraded": total("serving_degraded_total"),
           "cg_solves": total("cg_solves_total"),
           "cg_iterations": total("cg_iterations", __part="count")}
    table = gp_top.render(fams)
    print(table, flush=True)
    emit({"phase": "gp_metrics", "card": CARD, "n": n, "scrapes": scrapes,
          "families": len(fams), "counters": got, "health_status": health_json.get("status"),
          "breaker_state": health_json.get("breaker_state"), "launches": totals,
          "chaos_ok": result["metrics"]["chaos_ok"]})
    check(all(v > 0 for v in got.values()), f"scraped counters missing or zero: {got}")
    check(health_json.get("status") == "serving", f"/health said {health_json.get('status')}")
    return {"B1": totals["launches"], "B1_bf16": totals["bf16_launches"]}


# --------------------------------------------------------------------------
# the model zoo: SGPR, BLR, DKL and the multitask GP (phases sgpr, blr, dkl,
# multitask, multitask_mixed, gp_serve_zoo)
# --------------------------------------------------------------------------

ZOO_N = 40_000  # SGPR and BLR rows (the exact path's system size)
SGPR_M = 300  # SGPR's default inducing points (benchmarks/speed.py:313)
BLR_D = 64  # BLR's width (benchmarks/serve.py:96)
DKL_N = ZOO_N  # DKL's dense kernel forms K (n²) in every CG matmul
MT_N = 10_000  # multitask locations: n·T = 40,000 rows
MT_T = 4
MT_PROBES = 8
MT_ITERS = 25
MT_WIDTH = MT_T * (1 + MT_PROBES)  # the data kernel's columns per CG iteration: 36
MT_HADAMARD_ROWS = 30_000  # the panel with 25 % of the rows dropped
ZOO_BATCH = 1024
ZOO_APPEND = 64
ZOO_REQUESTS = 8
ZOO_OBSERVE_EVERY = 2
SOR_MLL_RTOL = 2e-3  # tests/test_gp_models.py:132
WOODBURY_POSTERIOR_RTOL = 1e-4
WOODBURY_APPEND_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_serving.py:213-218
LOW_RANK_CG_ITERS = 3  # the exact root preconditioner: O(1) iterations
DKL_TOL = dict(rtol=2e-3, atol=1e-4)
MT_MLL_RTOL = 1e-4
MT_GRAD_TOL = dict(rtol=2e-3, atol=1e-4)
MT_STRUCTURE_RTOL = 1e-5
MT_VAR_UNDERSHOOT = 1e-6


def _kin40k(seed, n, d=8):
    """kin40k-shaped data: X ~ U(−1, 1)^d, y = sin(3x₀)·cos(2x₇) + 0.05ε."""
    rng = np.random.default_rng([seed, 21, n, d])
    X = rng.uniform(-1, 1, (n, d)).astype("float32")
    y = (np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 7]) + 0.05 * rng.standard_normal(n)).astype("float32")
    Xq = rng.uniform(-1, 1, (ZOO_BATCH, d)).astype("float32")
    Xn = rng.uniform(-1, 1, (ZOO_APPEND, d)).astype("float32")
    yn = (np.sin(3 * Xn[:, 0]) * np.cos(2 * Xn[:, 7]) + 0.05 * rng.standard_normal(ZOO_APPEND))
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (X, y, Xq, Xn, yn))


@contextlib.contextmanager
def _cg_calls():
    """Count the engine's mBCG calls in the block."""
    from repro_torch.core import inference

    box, real = [0], inference.mbcg

    def counting(*a, **k):
        box[0] += 1
        return real(*a, **k)

    inference.mbcg = counting
    try:
        yield box
    finally:
        inference.mbcg = real


def _generator(seed=0):
    return torch.Generator(device="cuda").manual_seed(seed)


def _woodbury_f64(R, y, noise, Rs):
    """The exact low-rank posterior and MLL in f64: (mean, predictive
    variance) at the root rows Rs and −½(yᵀK̂⁻¹y + log|K̂| + n log 2π) for
    K̂ = RRᵀ + σ²I, through the m-dimensional Woodbury identity."""
    R, y, Rs = R.double(), y.double(), Rs.double()
    n, m = R.shape
    A = R.T @ R + noise * torch.eye(m, dtype=torch.float64, device=R.device)
    L = torch.linalg.cholesky(A)
    b = R.T @ y
    w = torch.cholesky_solve(b[:, None], L)[:, 0]
    V = torch.linalg.solve_triangular(L, Rs.T, upper=False)
    inv_quad = (y @ y - b @ w) / noise
    logdet = (n - m) * math.log(noise) + 2 * torch.log(torch.diagonal(L)).sum()
    mll = -0.5 * (inv_quad + logdet + n * math.log(2 * math.pi))
    return Rs @ w, noise * (V * V).sum(0) + noise, float(mll)


def _low_rank_phase(km, name, gp, X, y, Xq, Xn, yn, root64, fit_kw):
    """The shared body of phases sgpr and blr: MLL against the f64
    closed form, the CG count, three Adam steps, the Woodbury cache, one
    request against the f64 posterior, an append through the session
    against a rebuild with zero CG; no kernel launch anywhere."""
    from repro_torch.core import engine_state
    from repro_torch.serving import PosteriorSession

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.reset_launch_counts()
    t_phase = time.perf_counter()
    out = {"precision": gp.settings.precision}
    params0 = gp.init_params(X)
    with torch.no_grad():
        mll = -float(gp.loss(params0, X, y, _generator()))
        st = engine_state(gp.operator(params0, X), y, _generator(), gp.settings)
    R64, Rq64, noise64 = root64(params0, X, Xq)
    _, _, mll64 = _woodbury_f64(R64, y, noise64, Rq64)
    iters = int(st.cg_iters.max())
    out.update(mll=mll, mll_f64=mll64, mll_rel=abs(mll - mll64) / abs(mll64), cg_iters=iters)
    if gp.settings.precision == "highest":
        check(out["mll_rel"] <= SOR_MLL_RTOL, f"{name}: MLL {mll} vs f64 {mll64}")
        check(iters <= LOW_RANK_CG_ITERS,
              f"{name}: {iters} CG iterations with the exact root preconditioner")
    else:
        check(abs(mll - mll64) / X.shape[0] <= MIXED_MLL_PER_POINT,
              f"{name} mixed: MLL {mll} vs f64 {mll64}")

    steps = []

    def on_step(i, loss):
        torch.cuda.synchronize()
        steps.append({"step": i, "loss": loss, "ms": (time.perf_counter() - t0[0]) * 1e3})
        t0[0] = time.perf_counter()

    t0 = [time.perf_counter()]
    params, history = gp.fit(X, y, steps=3, callback=on_step, **fit_kw)
    check(all(math.isfinite(h) for h in history), f"{name}: non-finite training loss")
    out["train_steps"] = steps
    out["step_profile"] = profile_step(gp, X, y)
    if "inducing" in params0:
        frozen, _ = gp.fit(X, y, steps=1, learn_inducing=False)
        check(torch.equal(frozen["inducing"], params0["inducing"]),
              f"{name}: learn_inducing=False moved the inducing points")
        check(not torch.equal(params["inducing"], params0["inducing"]),
              f"{name}: the inducing points did not move when learned")

    with torch.no_grad():
        cache, out["cache_build_ms"], _ = timed(lambda: gp.posterior_cache(params, X, y))
        (mean, var), out["request_ms"], _ = timed(lambda: gp.predict_cached(params, X, cache, Xq))
        R64, Rq64, noise64 = root64(params, X, Xq)
        mean64, var64, _ = _woodbury_f64(R64, y, noise64, Rq64)
    out["mean_rel"] = float((mean.double() - mean64).abs().max() / mean64.abs().max())
    out["var_rel"] = float(((var.double() - var64) / var64).abs().max())
    check(out["mean_rel"] <= WOODBURY_POSTERIOR_RTOL and out["var_rel"] <= WOODBURY_POSTERIOR_RTOL,
          f"{name}: Woodbury posterior {out['mean_rel']:.2e} / {out['var_rel']:.2e} from f64")

    session = PosteriorSession(gp, params, X, y)
    with _cg_calls() as cg:
        path, out["append_ms"], _ = timed(lambda: session.observe(Xn, yn))
        appended = session.query(Xq)
    # the rank-k refresh alone: observe adds the concatenation of (X, y)
    # and the chained digest of the appended rows
    out["update_cache_ms"] = timed(lambda: gp.update_cache(params, None, None, cache, Xn, yn))[1]
    check(path == "append" and cg[0] == 0, f"{name}: append took {path} with {cg[0]} CG solves")
    rebuilt = PosteriorSession(gp, params, torch.cat([X, Xn]), torch.cat([y, yn])).query(Xq)
    out["append_vs_rebuild"] = [rel_err(a, b)[1] for a, b in zip(appended, rebuilt)]
    for a, b in zip(appended, rebuilt):
        check(bool(torch.allclose(a, b, **WOODBURY_APPEND_TOL)), f"{name}: append vs rebuild")
    torch.cuda.synchronize()
    out["launches"] = _dtype_counts(km)
    check(all(v == 0 for v in km.launch_counts().values()), f"{name}: a kernel launched")
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def phase_sgpr(km, seed):
    """SGPR(num_inducing=300) at n = 40,000 (RBF, precond_rank=1,
    max_cg_iters=40), at "highest" and at "mixed": the MLL against an f64
    SoR MLL from the same root, the CG iterations (O(1) with the root
    preconditioner), three Adam steps learning the inducing points and one
    with them frozen (unchanged bit for bit), the Woodbury cache, a 1,024-
    point request against the f64 SoR posterior, a 64-point append through
    PosteriorSession against a rebuild with zero CG; no kernel launch."""
    from repro_torch import SGPR

    X, y, Xq, Xn, yn = _kin40k(seed, ZOO_N)

    def root64(params, X, Xq):
        p = {k: v.double() for k, v in params.items()}
        kern = gp.kernel(p)
        U = p["inducing"]
        L = torch.linalg.cholesky(kern(U, U) + gp.jitter * torch.eye(
            U.shape[0], dtype=torch.float64, device=U.device))
        rows = lambda A: torch.linalg.solve_triangular(L, kern(A.double(), U).T, upper=False).T  # noqa: E731
        return rows(X), rows(Xq), float(gp.noise(p))

    rows = {}
    for precision in ("highest", "mixed"):
        gp = SGPR(num_inducing=SGPR_M, precision=precision)
        rows[precision] = _low_rank_phase(km, "sgpr", gp, X, y, Xq, Xn, yn, root64, {})
    emit({"phase": "sgpr", "card": CARD, "n": ZOO_N, "num_inducing": SGPR_M, **rows})
    return rows


def phase_blr(km, seed):
    """BayesianLinearRegression at n = 40,000, d = 64: as phase sgpr
    against the f64 closed-form posterior; no kernel launch."""
    from repro_torch import BayesianLinearRegression

    X, y, Xq, Xn, yn = _kin40k(seed, ZOO_N, BLR_D)

    def root64(params, X, Xq):
        s = torch.nn.functional.softplus(params["raw_prior_scale"].double())
        return X.double() * s, Xq.double() * s, float(gp.noise({k: v.double()
                                                                for k, v in params.items()}))

    gp = BayesianLinearRegression()
    row = _low_rank_phase(km, "blr", gp, X, y, Xq, Xn, yn, root64, {})
    emit({"phase": "blr", "card": CARD, "n": ZOO_N, "d": BLR_D, **row})
    return row


def phase_dkl(km, seed):
    """DKLExactGP(hidden=(32, 32, 2)) at n = 40,000 in dense mode: the MLL
    and every weight's gradient over a 5-iteration CG prefix against the
    same computation in float64 (rtol 2e-3 / atol 1e-4; precond_rank=0 so
    the two precisions draw the same probes and have no pivots to choose),
    two Adam steps at the class's settings, a Krylov cache build, one
    1,024-point request; no kernel launch."""
    from repro_torch import DKLExactGP
    from repro_torch.core import BBMMSettings, marginal_log_likelihood, tensor_leaves
    from repro_torch.gp.training import tree_map

    X, y, Xq, _, _ = _kin40k(seed, DKL_N)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    km.reset_launch_counts()
    t_phase = time.perf_counter()
    prefix = BBMMSettings(max_cg_iters=PREFIX_ITERS, precond_rank=0)
    gp = DKLExactGP(settings=prefix)
    params0 = gp.init_params(X)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        p = tree_map(lambda v: v.detach().to(dtype).requires_grad_(), params0)
        op = gp.operator(p, X)
        op = dataclasses.replace(op, base=dataclasses.replace(op.base, X=X.to(dtype)))
        loss = -marginal_log_likelihood(op, y.to(dtype), _generator(), prefix)
        loss.backward()
        grads[dtype] = (float(loss), [leaf.grad for leaf in tensor_leaves(p)])
        del op, loss
        torch.cuda.empty_cache()
    (l32, g32), (l64, g64) = grads[torch.float32], grads[torch.float64]
    mll_rel = abs(l32 - l64) / abs(l64)
    check(mll_rel <= DKL_TOL["rtol"], f"dkl: prefix MLL {l32} vs f64 {l64}")
    # the leaves in order: each layer's w and b, then ℓ, s, σ².  The last
    # layer's bias moves every feature alike, which a stationary kernel
    # cannot see: its gradient is 0 up to rounding (held to 1e-4 of the
    # largest weight gradient, as tests/test_torch_dkl.py holds it)
    last_bias = 2 * len(params0["net"]) - 1
    scale = max(float(g.abs().max()) for g in g32)
    for i, a in enumerate(g32):
        check(a is not None and bool(torch.isfinite(a).all()), f"dkl: leaf {i} has no gradient")
    # each leaf's gradient relative to its size (the script's convention,
    # GRAD_RTOL): max |Δ| ≤ rtol · max |f64| + atol
    grad_rel = [rel_err(a.double(), b)[1] for a, b in zip(g32, g64)]
    grad_ok = [float((a.double() - b).abs().max()) <= DKL_TOL["rtol"] * float(b.abs().max())
               + DKL_TOL["atol"] for a, b in zip(g32, g64)]
    leaves = len(g32)

    steps, t0 = [], [time.perf_counter()]

    def on_step(i, loss):
        torch.cuda.synchronize()
        steps.append({"step": i, "loss": loss, "ms": (time.perf_counter() - t0[0]) * 1e3})
        t0[0] = time.perf_counter()

    gp = DKLExactGP()
    params, history = gp.fit(X, y, steps=2, callback=on_step)
    check(all(math.isfinite(h) for h in history), "dkl: non-finite training loss")
    step_profile = profile_step(gp, X, y)
    with torch.no_grad():
        cache, build_ms, _ = timed(lambda: gp.posterior_cache(params, X, y))
        (mean, var), request_ms, _ = timed(lambda: gp.predict_cached(params, X, cache, Xq))
    row = {"phase": "dkl", "card": CARD, "n": DKL_N, "hidden": list(gp.hidden),
           "prefix_mll_rel": mll_rel, "prefix_leaves": leaves,
           "prefix_grad_rel": grad_rel, "last_bias_grad_over_scale":
               float(g32[last_bias].abs().max()) / scale, "train_steps": steps,
           "step_profile": step_profile,
           "cache_build_ms": build_ms, "request_ms": request_ms,
           "launches": _dtype_counts(km), "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    for i, ok in enumerate(grad_ok):
        if i == last_bias:  # a shift of every feature: 0 up to rounding
            check(row["last_bias_grad_over_scale"] <= 1e-4, "dkl: the last bias has a gradient")
        else:
            check(ok and float(g32[i].abs().max()) > 0, f"dkl: leaf {i} gradient vs f64")
    check(bool(torch.isfinite(mean).all() & (var > 0).all()), "dkl: served non-finite output")
    check(all(v == 0 for v in km.launch_counts().values()), "dkl: a kernel launched")
    return row


@contextlib.contextmanager
def _data_kernel_widths():
    """Record (columns, whether M arrived contiguous) for every data-kernel
    product of the cuda path — each ``PreparedKernelOperator.matmul``, the
    one seam of the f32 and the bf16 launches; a non-contiguous M costs one
    copy before the launch."""
    from repro_torch.gp.kernels import PreparedKernelOperator

    widths, real = [], PreparedKernelOperator.matmul

    def recording(self, M):
        widths.append((M.shape[-1], M.is_contiguous()))
        return real(self, M)

    PreparedKernelOperator.matmul = recording
    try:
        yield widths
    finally:
        PreparedKernelOperator.matmul = real


def _multitask_data(seed):
    """The multitask panel: n = 10,000 kin40k-shaped locations crossed with
    T = 4 tasks (gp_serve's task targets), 1,024 long-format query rows, and
    the Hadamard panel with 25 % of the rows dropped (seeded)."""
    from repro_torch.gp import to_long_format
    from repro_torch.launch import gp_serve

    rng = np.random.default_rng([seed, 22])
    X = rng.uniform(-1, 1, (MT_N, 8)).astype("float32")
    Xl, yl = to_long_format(X, gp_serve._task_targets(rng, X, MT_T))
    Xq = to_long_format(rng.uniform(-1, 1, (ZOO_BATCH, 8)), task_ids=rng.integers(0, MT_T, ZOO_BATCH),
                        num_tasks=MT_T)
    keep = np.sort(rng.permutation(Xl.shape[0])[:MT_HADAMARD_ROWS])
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                 for a in (Xl, yl, Xq, Xl[keep], yl[keep]))


def _multitask_exact_variance(gp, params, data, Xq):
    """The exact posterior variance at long-format queries in f64: K̂ formed
    densely ((n·T)², 12.8 GB at n·T = 40,000) and factored once."""
    from repro_torch.gp.multitask import split_long_format

    p = {k: v.double() for k, v in params.items()}
    kern, KT, noise = gp.kernel(p), gp.task_covariance(p), gp.noise(p)
    Xd = data.X.double()
    K = torch.kron(kern(Xd, Xd), KT)
    K.diagonal().add_(noise.repeat(Xd.shape[0]))
    L = torch.linalg.cholesky(K)
    del K
    coords, qt = split_long_format(Xq.double())
    Kx = kern(Xd, coords)
    Kxs = (Kx[:, None, :] * KT[:, qt][None]).reshape(L.shape[0], -1)
    V = torch.linalg.solve_triangular(L, Kxs, upper=False)
    var = kern.diag(coords) * torch.diagonal(KT)[qt] - (V * V).sum(0) + noise[qt]
    del L, V
    torch.cuda.empty_cache()
    return var


def _rbf_yardstick(Xs, M, bf16=False):
    """torch.cdist → RBF map → torch.matmul (a bf16 one with ``bf16``): the
    library composition for K·M at the multitask kernel.  Timed only."""
    K = torch.exp(-0.5 * torch.cdist(Xs, Xs) ** 2)
    if bf16:
        K, M = K.to(torch.bfloat16), M.to(torch.bfloat16)
    return K @ M


def _rbf_grad_yardstick(Xs, M, C, rows=8192):
    """Autograd through the RBF yardstick, a row slice at a time: the
    gradient for X (both sides) and the outputscale.  Timed only."""
    X1 = Xs.detach().requires_grad_()
    s = torch.ones((), device=Xs.device, requires_grad=True)
    for i in range(0, Xs.shape[0], rows):
        K = s * torch.exp(-0.5 * torch.cdist(X1[i : i + rows], X1) ** 2)
        (K @ M).backward(C[i : i + rows])
    return X1.grad, s.grad


def _time_multitask_kernels(km, rng):
    """B1 (f32 and bf16) and the symmetric VJP at the multitask width, n =
    10,000 and t = 36, beside their plain versions, the library composition
    and the card's bound (``kernel_bound`` / ``grad_bound``)."""
    from repro_torch.kernels.kernel_matmul.ref import (
        kernel_matmul_grad_sym_plain,
        kernel_matmul_plain,
    )

    dev = torch.device("cuda")
    n, d, t = MT_N, 8, MT_WIDTH
    Xs = torch.from_numpy((rng.uniform(-1, 1, (n, d)) / 0.5).astype("float32")).to(dev)
    M, C = _randn(rng, (n, t), dev), _randn(rng, (n, t), dev)
    rows = {}
    for label, bf16 in (("B1", False), ("B1_bf16", True)):
        Xk = Xs.to(torch.bfloat16).float() if bf16 else Xs
        cd = "bfloat16" if bf16 else "float32"
        ms = time_ms(lambda: km.kernel_matmul_cuda(Xk, Xk, M, 1.0, 0.0, kernel_type="rbf",
                                                   compute_dtype=cd), reps=20)
        plain_ms = time_ms(lambda: kernel_matmul_plain(Xk, Xk, M, 1.0, 0.0, kernel_type="rbf",
                                                       compute_dtype=cd), reps=3)
        library_ms = time_ms(lambda: _rbf_yardstick(Xk, M, bf16), reps=3)
        bound_ms, bound_by, _ = kernel_bound(n, n, d, t, bf16=bf16)
        rows[label] = {"n": n, "d": d, "t": t, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                       "bound_share": bound_ms / ms}
    ms = time_ms(lambda: km.kernel_matmul_grad_sym_cuda(Xs, M, C, 1.0, 0.0, kernel_type="rbf"),
                 reps=10)
    plain_ms = time_ms(lambda: kernel_matmul_grad_sym_plain(Xs, M, C, 1.0, 0.0, kernel_type="rbf"),
                       reps=2)
    library_ms = time_ms(lambda: _rbf_grad_yardstick(Xs, M, C), reps=2)
    bound_ms, bound_by = grad_bound(n, d, t)
    rows["grad"] = {"n": n, "d": d, "t": t, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_share": bound_ms / ms}
    for label, row in rows.items():
        emit({"phase": "timing", "kernel": f"{label}_multitask", "card": CARD, **row})
    torch.cuda.empty_cache()
    return rows


def phase_multitask(km, seed, precision="highest", highest=None, rng=None):
    """MultitaskGP(num_tasks=4, mode="cuda") on n = 10,000 locations × 4
    tasks (40,000 rows), RBF, task rank 1, 8 probes, 25 iterations, rank 0.

    * a 5-iteration prefix of the MLL and its gradients (lengthscale,
      outputscale, task root, task diagonal, noise) on mode="cuda" against
      mode="dense" with the same probes (MLL 1e-4 relative, gradients rtol
      2e-3 / atol 1e-4; "mixed": 1e-2 per point and 1e-2), and the Kronecker
      operator against structure="hadamard" forced on the grid (1e-5);
    * a training step at the full 25 iterations: one B1 launch at t = 36
      columns per CG iteration (bf16 under "mixed", with f32 refreshes),
      the backward's primal and ONE gradient launch; no B3;
    * a cache build, a 1,024-row long-format request (no launch), a
      256-row predict: its mean equal to predict_cached's bit for bit, the
      cached variance no lower than the exact f64 posterior variance −
      1e-6 ("highest");
    * the Hadamard panel (m = 30,000 rows): a training step, a cache build
      and a request, B1 at t = 36 over the panel's rows.
    """
    from repro_torch import MultitaskGP
    from repro_torch.core import BBMMSettings, health

    Xl, yl, Xq, Xh, yh = _multitask_data(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mixed = precision == "mixed"
    settings = BBMMSettings(num_probes=MT_PROBES, max_cg_iters=MT_ITERS, precond_rank=0)
    gp = MultitaskGP(num_tasks=MT_T, mode="cuda", settings=settings, precision=precision)
    data = gp.prepare_inputs(Xl)
    check(data.task_ids is None and data.X.shape[0] == MT_N, "multitask: the grid was not detected")
    params0 = gp.init_params(Xl)
    out = {"precision": precision}

    # the prefix: cuda against dense (and the Hadamard gather on the grid)
    prefix = dataclasses.replace(gp.settings, max_cg_iters=PREFIX_ITERS)
    vals = {}
    for mode, structure in (("cuda", "auto"), ("dense", "auto"), ("cuda", "hadamard")):
        m = MultitaskGP(num_tasks=MT_T, mode=mode, structure=structure, settings=prefix)
        p = {k: v.clone().requires_grad_() for k, v in params0.items()}
        loss = m.loss(p, m.prepare_inputs(Xl), yl, _generator())
        grads = torch.autograd.grad(loss, list(p.values())) if structure == "auto" else None
        vals[(mode, structure)] = (float(loss), grads)
        del loss
    (lc, gc), (ld, gd) = vals[("cuda", "auto")], vals[("dense", "auto")]
    lh = vals[("cuda", "hadamard")][0]
    out["prefix_mll"] = lc
    with torch.no_grad():  # the served mean from a cache of the prefix's depth
        pgp = MultitaskGP(num_tasks=MT_T, mode="cuda", settings=prefix)
        out["prefix_served_mean"] = pgp.predict_cached(
            params0, data, pgp.posterior_cache(params0, data, yl), Xq)[0]
    out["prefix_mll_rel"] = abs(lc - ld) / abs(ld)
    out["hadamard_vs_kronecker_mll_rel"] = abs(lh - lc) / abs(lc)
    out["prefix_grad_rel"] = {k: rel_err(a, b)[1] for k, a, b in zip(params0, gc, gd)}
    if mixed:
        check(abs(lc - ld) / yl.shape[0] <= MIXED_MLL_PER_POINT, f"multitask mixed: {lc} vs {ld}")
        for k, a, b in zip(params0, gc, gd):
            check(rel_err(a, b)[1] <= MIXED_GRAD_RTOL, f"multitask mixed: d/d{k} vs dense")
    else:
        check(out["prefix_mll_rel"] <= MT_MLL_RTOL, f"multitask: prefix MLL {lc} vs dense {ld}")
        for k, a, b in zip(params0, gc, gd):
            check(bool(torch.allclose(a, b, **MT_GRAD_TOL)), f"multitask: d/d{k} cuda vs dense")
    check(out["hadamard_vs_kronecker_mll_rel"] <= (MIXED_MLL_PER_POINT if mixed else MT_STRUCTURE_RTOL),
          f"multitask: Hadamard {lh} vs Kronecker {lc}")
    if not mixed:
        op = gp.operator(params0, data)
        had = MultitaskGP(num_tasks=MT_T, mode="cuda", structure="hadamard")
        oph = had.operator(params0, had.prepare_inputs(Xl))
        Mt = torch.randn(Xl.shape[0], MT_PROBES + 1, device=Xl.device,
                         generator=_generator(1))
        with torch.no_grad():
            a, b = op.matmul(Mt), oph.matmul(Mt)
        out["hadamard_vs_kronecker_matmul_rel"] = rel_err(b, a)[1]
        check(out["hadamard_vs_kronecker_matmul_rel"] <= MT_STRUCTURE_RTOL,
              "multitask: Hadamard matmul vs Kronecker")
        del a, b, Mt

    # a training step at full depth, launches and widths recorded
    p = MT_ITERS
    f32_loop = p // settings.cg_refresh_every + 1 if mixed else p
    want_fwd = {"B1_bf16": p if mixed else 0, "B1": f32_loop, "grad": 0}
    params = {k: v.clone().requires_grad_() for k, v in params0.items()}
    km.reset_launch_counts()
    with _data_kernel_widths() as widths:
        loss, fwd_ms, fwd_dev_ms = timed(lambda: gp.loss(params, data, yl, _generator()))
        fwd = _dtype_counts(km)
        _, bwd_ms, bwd_dev_ms = timed(lambda: loss.backward())
    step = _dtype_counts(km)
    out.update(train_forward_ms=fwd_ms, train_forward_device_ms=fwd_dev_ms,
               train_backward_ms=bwd_ms, train_backward_device_ms=bwd_dev_ms,
               train_loss=float(loss), train_launches=step)
    check({k: fwd[k] for k in want_fwd} == want_fwd, f"multitask forward launches {fwd}")
    check(step["B1"] == fwd["B1"] + 1 and step["grad"] == 1 and step["B3"] == 0
          and step["B3_bf16"] == 0 and step["B2"] == 0,
          f"multitask step launches {step}: the backward is one B1 and one gradient launch")
    check(all(w == MT_WIDTH for w, _ in widths),
          f"multitask: data-kernel widths {sorted(set(widths))}, {MT_WIDTH} expected")
    out["train_data_kernel_calls"] = len(widths)
    out["train_copies_before_launch"] = sum(1 for _, c in widths if not c)
    check(all(math.isfinite(float(g.abs().max())) for g in (v.grad for v in params.values())),
          "multitask: non-finite gradient")
    del loss
    params = {k: v.detach() for k, v in params0.items()}
    if not mixed:
        km.reset_launch_counts()
        out["step_profile"] = profile_step(gp, Xl, yl, data=data)

    # serving
    km.reset_launch_counts()
    with health.collect() as reports:
        cache, out["cache_build_ms"], out["cache_build_device_ms"] = timed(
            lambda: gp.posterior_cache(params, data, yl))
    out["cache_build_launches"] = _dtype_counts(km)
    out["cache_status"] = [r.status for r in reports]
    km.reset_launch_counts()
    (qmean, qvar), out["request_ms"], _ = timed(lambda: gp.predict_cached(params, data, cache, Xq))
    out["request_warm_ms"] = [timed(lambda: gp.predict_cached(params, data, cache, Xq))[1]
                              for _ in range(3)]
    check(sum(_dtype_counts(km).values()) == 0, "multitask: a cached request launched a kernel")
    check(bool(torch.isfinite(qmean).all() & (qvar > 0).all()), "multitask: served non-finite output")
    P = Xq[:256]
    (pmean, pvar), out["predict_256_ms"], _ = timed(lambda: gp.predict(params, data, yl, P))
    cmean, cvar = gp.predict_cached(params, data, cache, P)
    check(torch.equal(pmean, cmean), "multitask: predict's mean differs from predict_cached's")
    out["served_mean"] = qmean
    if not mixed:
        exact = _multitask_exact_variance(gp, params, data, P)
        out["cached_var_max_undershoot"] = float((exact - cvar.double()).max())
        check(out["cached_var_max_undershoot"] <= MT_VAR_UNDERSHOOT,
              f"multitask: cached variance undershoots the exact one by "
              f"{out['cached_var_max_undershoot']:.3e}")
    else:
        # at 25 iterations neither precision has converged, and two correct
        # paths part by about their distance from the answer (phase
        # serve_mixed): the full depth is reported, the prefix gated
        out["mean_vs_highest"] = _rel_norm(qmean, highest["served_mean"])
        out["mll_vs_highest_per_point"] = abs(out["train_loss"] - highest["train_loss"]) / yl.shape[0]
        out["prefix_mean_vs_highest"] = _rel_norm(out["prefix_served_mean"],
                                                  highest["prefix_served_mean"])
        out["prefix_mll_vs_highest_per_point"] = abs(lc - highest["prefix_mll"]) / yl.shape[0]
        check(out["prefix_mean_vs_highest"] <= MIXED_MEAN_REL,
              f"multitask mixed: served mean {out['prefix_mean_vs_highest']:.3e} from highest")
        check(out["prefix_mll_vs_highest_per_point"] <= MIXED_MLL_PER_POINT,
              "multitask mixed: the MLL per point moved from highest")
    del cache

    # the Hadamard panel
    km.reset_launch_counts()
    hdata = gp.prepare_inputs(Xh)
    check(hdata.task_ids is not None and hdata.X.shape[0] == MT_HADAMARD_ROWS,
          "multitask: the panel was not classified heterogeneous")
    hp = {k: v.clone().requires_grad_() for k, v in params0.items()}
    with _data_kernel_widths() as widths:
        _, out["hadamard_step_ms"], _ = timed(
            lambda: gp.loss(hp, hdata, yh, _generator()).backward())
    out["hadamard_step_launches"] = _dtype_counts(km)
    out["hadamard_step_warm_ms"] = timed(
        lambda: gp.loss(hp, hdata, yh, _generator()).backward())[1]
    check(out["hadamard_step_launches"]["grad"] == 1 and all(w == MT_WIDTH for w, _ in widths),
          f"multitask Hadamard step: {out['hadamard_step_launches']}, widths {sorted(set(widths))}")
    with torch.no_grad():
        hcache, out["hadamard_cache_build_ms"], _ = timed(lambda: gp.posterior_cache(params, hdata, yh))
        (hm, hv), out["hadamard_request_ms"], _ = timed(
            lambda: gp.predict_cached(params, hdata, hcache, Xq))
    check(bool(torch.isfinite(hm).all() & (hv > 0).all()), "multitask Hadamard: non-finite output")
    del hcache
    if rng is not None:
        out["timing"] = _time_multitask_kernels(km, rng)
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "multitask_mixed" if mixed else "multitask", "card": CARD, "n": MT_N,
          "tasks": MT_T, "rows": MT_N * MT_T, "width": MT_WIDTH,
          **{k: v for k, v in out.items() if k not in ("served_mean", "prefix_served_mean")}})
    torch.cuda.empty_cache()
    return out


def _mt_launches(row):
    """A multitask phase's launches by counter (its step, builds and panel)."""
    total = {}
    for key in ("train_launches", "cache_build_launches", "hadamard_step_launches"):
        for k, v in row[key].items():
            total[k] = total.get(k, 0) + v
    return total


def phase_gp_serve_zoo(km, seed):
    """gp_serve's drivers for the ported models: run_serve for sgpr and blr
    at n = 40,000 (blr d = 64), dkl at 40,000 and multitask at 10,000
    locations × 4 tasks, 8 requests of 1,024 points and an append of 64
    points (a task block each for multitask) every 2; run_serve_threaded
    with 4 workers for sgpr, every answer replayed bit for bit from the
    state it reports.  Gates: nothing raised, every observe an append, the
    Woodbury appends 0 CG solves."""
    import threading

    from repro_torch.gp.model import WoodburyCachePredictor
    from repro_torch.launch import gp_serve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    rows, launches = {}, {}
    appends_cg = []
    real_update = WoodburyCachePredictor.update_cache

    def counted_update(self, *a, **kw):
        with _cg_calls() as cg:
            out = real_update(self, *a, **kw)
        appends_cg.append(cg[0])
        return out

    WoodburyCachePredictor.update_cache = counted_update
    try:
        for model, n, d in (("sgpr", ZOO_N, 8), ("blr", ZOO_N, BLR_D), ("dkl", DKL_N, 8),
                            ("multitask", MT_N, 8)):
            km.reset_launch_counts()
            t0 = time.perf_counter()
            m = gp_serve.run_serve(model=model, n=n, d=d, requests=ZOO_REQUESTS, batch=ZOO_BATCH,
                                   observe_every=ZOO_OBSERVE_EVERY, observe_batch=ZOO_APPEND,
                                   num_tasks=MT_T, seed=seed, verbose=False)
            launches[model] = _dtype_counts(km)
            check(m["num_appends"] == ZOO_REQUESTS // ZOO_OBSERVE_EVERY and not m["num_rebuilds"],
                  f"zoo {model}: {m['num_appends']} appends, {m['num_rebuilds']} rebuilds")
            rows[model] = {k: m[k] for k in ("cache_build_s", "cached_qps", "query_ms",
                                             "append_s", "append_avg_s", "rebuild_s", "final_n")}
            rows[model].update(seconds=time.perf_counter() - t0, launches=launches[model])
        check(len(appends_cg) == 2 * ZOO_REQUESTS // ZOO_OBSERVE_EVERY and not any(appends_cg),
              f"Woodbury appends ran CG: {appends_cg}")
        for model in ("sgpr", "blr", "dkl"):
            check(sum(launches[model].values()) == 0, f"zoo {model}: a kernel launched")
        check(launches["multitask"]["B1"] > 0, "zoo multitask: no B1 launch")

        served, lock = [], threading.Lock()

        def on_query(r, Xq, answer, s):
            with lock:
                served.append((r, Xq, answer, s))

        state = {}
        m = gp_serve.run_serve_threaded(
            model="sgpr", n=ZOO_N, d=8, requests=ZOO_REQUESTS, batch=ZOO_BATCH,
            observe_every=ZOO_OBSERVE_EVERY, observe_batch=ZOO_APPEND, threads=THREADS, seed=seed,
            session_hook=lambda s: state.setdefault("session", s), query_hook=on_query,
            timeout_s=JOIN_TIMEOUT_S, verbose=False)
    finally:
        WoodburyCachePredictor.update_cache = real_update
    check(len(served) == ZOO_REQUESTS, f"zoo threaded: {len(served)} answers")
    gp = state["session"].model
    for r, Xq, (mean, var), s in served:
        again = gp.predict_cached(s.params, s.data, s.cache, Xq)
        check(torch.equal(again[0], mean) and torch.equal(again[1], var),
              f"zoo threaded: query {r} does not replay from cache v{s.info.version}")
    rows["sgpr_threaded"] = {k: m[k] for k in ("concurrent_qps", "query_ms_p50",
                                               "async_refreshes_swapped",
                                               "async_refreshes_discarded", "cache_version")}
    emit({"phase": "gp_serve_zoo", "card": CARD, "batch": ZOO_BATCH, "requests": ZOO_REQUESTS,
          "append_rows": ZOO_APPEND, "woodbury_append_cg_solves": sum(appends_cg), **rows,
          "peak_device_bytes": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t_phase})
    return {"B1": launches["multitask"]["B1"], "B1_bf16": launches["multitask"]["B1_bf16"],
            "grad": launches["multitask"]["grad"]}


def _streamed(streaming, key):
    """The new streaming / health phases' launches of one kernel."""
    return sum(r.get(key, 0) for r in streaming.values())


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n", type=int, default=40_000, help="training points of the slice")
    args = parser.parse_args()

    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))

    from repro_torch.kernels import build
    from repro_torch.kernels.kernel_matmul import kernel_matmul as km
    from repro_torch.kernels.kernel_matmul.ref import kernel_matmul_plain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global CARD
    CARD = smi
    emit({"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "seed": args.seed})

    rng = np.random.default_rng(args.seed)
    errs = {"B1": 0.0, "B2": 0.0, "B3": 0.0, "grad": 0.0, "B4": 0.0, "B5": 0.0,
            "B5_recurrence": 0.0, "B5_cuda_cores": 0.0, "B5_cuda_cores_recurrence": 0.0,
            "B1_bf16": 0.0, "B2_bf16": 0.0, "B3_bf16": 0.0}
    # the bf16 kernel phases draw from a generator of their own too
    rng_bf16 = np.random.default_rng([args.seed, 17])
    # the LM phases draw from a generator of their own, so that they leave
    # the GP phases' data as it was; so does the batched kernel phase
    rng_lm = np.random.default_rng([args.seed, 13])
    rng_batched = np.random.default_rng([args.seed, 18])
    t_gram = 9 * 26  # (num_probes + 1) · (max_cg_iters + 1) basis columns
    t_start = time.perf_counter()
    try:
        phase_build(build)
        phase_kernel(km, kernel_matmul_plain, rng, errs)
        phase_fused_kernel(km, rng, errs)
        phase_grad_kernel(km, rng, errs)
        phase_kernel_bf16(km, kernel_matmul_plain, rng_bf16, errs)
        phase_fused_kernel_bf16(km, rng_bf16, errs)
        phase_flash_kernel(rng_lm, errs)
        phase_ssd_kernel(rng_lm, errs)
        timing = phase_timing(km, kernel_matmul_plain, rng, args.n, t_gram)
        timing.update(phase_lm_timing(rng_lm))
        # the serving and training data have their own generator, so adding
        # a case to an earlier phase does not change the problem the slices
        # solve
        launches, batched, build_ms, req_ms, serve_data, highest = phase_serve(
            km, np.random.default_rng(args.seed), args.n)
        serve_mixed, mixed_serving = phase_serve_mixed(km, serve_data, highest)
        del serve_data
        torch.cuda.empty_cache()
        train, history, steps = phase_train(km, args.seed, args.n)
        train_mixed, mixed_steps = phase_train_mixed(km, args.seed, args.n, history)
        phase_batched_kernel(km, kernel_matmul_plain, rng_batched, args.n, errs)
        multi, multi_rows = phase_multi_output(km, args.seed, args.n)
        restart = phase_multi_restart(km, args.seed)
        torch.cuda.empty_cache()
        panels = phase_panel_parity(km, args.seed, errs)
        sweep = phase_panel_sweep(km, args.seed)
        serve_part, serve_part_times = phase_serve_partitioned(km, args.seed)
        train_part, train_part_times = phase_train_partitioned(km, args.seed)
        torch.cuda.empty_cache()
        million, million_stats = phase_million(km, args.seed)
        torch.cuda.empty_cache()
        streaming = {}
        for name, phase in (("gp_stream", phase_gp_stream), ("gp_threaded", phase_gp_threaded),
                            ("gp_ladder", phase_gp_ladder), ("gp_chaos", phase_gp_chaos),
                            ("gp_metrics", phase_gp_metrics)):
            t_phase = time.perf_counter()
            streaming[name] = phase(km, args.seed, args.n)
            streaming[name]["seconds"] = time.perf_counter() - t_phase
            torch.cuda.empty_cache()
        # the model zoo: each phase resets the counters before it and reads
        # them after; its wall time and peak memory are in its line
        zoo, zoo_seconds = {}, {}
        rng_zoo = np.random.default_rng([args.seed, 23])
        for name, run in (
            ("sgpr", lambda: phase_sgpr(km, args.seed)),
            ("blr", lambda: phase_blr(km, args.seed)),
            ("dkl", lambda: phase_dkl(km, args.seed)),
            ("multitask", lambda: phase_multitask(km, args.seed, rng=rng_zoo)),
            ("multitask_mixed", lambda: phase_multitask(km, args.seed, "mixed",
                                                        highest=zoo["multitask"])),
            ("gp_serve_zoo", lambda: phase_gp_serve_zoo(km, args.seed)),
        ):
            t_phase = time.perf_counter()
            zoo[name] = run()
            zoo_seconds[name] = time.perf_counter() - t_phase
            emit({"phase_wall_s": name, "seconds": zoo_seconds[name]})
            torch.cuda.empty_cache()
        mt_launches = {k: _mt_launches(zoo[k]) for k in ("multitask", "multitask_mixed")}
        mt_timing = zoo["multitask"]["timing"]
        phase_lm_parity(args.seed, PARITY_LAYERS, tol=LM_PARITY_TOL, decode=True)
        phase_lm_parity(args.seed, FULL_LAYERS, tol=None, decode=False)
        lm = phase_lm_serve(args.seed)
    except Exception:  # every phase failure ends the run non-zero
        traceback.print_exc()
        return 1

    emit({"serving": {"build_ms": build_ms,
                      "request_ms_mean": sum(req_ms) / len(req_ms),
                      "b1_ms_per_launch_n_t9": timing["B1"]["ms"],
                      "b1_ms_gram_t": timing["B1_gram"]["ms"],
                      "b1_ms_t256": timing["B1_predict"]["ms"]},
          "training": {"loss_history": history,
                       "step_ms": [st["ms"] for st in steps],
                       "b3_ms_per_launch_n_t9": timing["B3"]["ms"],
                       "grad_ms_per_vjp_n_t9": timing["grad"]["ms"]},
          "mixed": {"serving": mixed_serving,
                    "training_step_ms": [st["ms"] for st in mixed_steps],
                    "b1_bf16_ms_t9": timing["B1_bf16"]["ms"],
                    "b1_bf16_ms_t256": timing["B1_bf16_predict"]["ms"],
                    "b3_bf16_ms_t9": timing["B3_bf16"]["ms"]},
          "multi_output": {k: {"warm_step_ms": r["warm_step_ms"]} for k, r in multi_rows.items()},
          "multi_restart_rel_err": restart,
          "partitioned": {"n": PARTITIONED_N, "panel_rows": panels["panel_rows"],
                          "num_panels": panels["num_panels"], **serve_part_times,
                          **train_part_times, "sweep": sweep},
          "million": million_stats,
          "streaming_phase_seconds": {k: v["seconds"] for k, v in streaming.items()},
          "zoo": {"phase_seconds": zoo_seconds,
                  "multitask_launches": mt_launches,
                  "multitask_ms_t36": {k: v["ms"] for k, v in mt_timing.items()}},
          "lm_serving": {"arch": "zamba2-7b", "prefill_ms": lm["prefill_ms"],
                         "prefill_warm_ms": lm["prefill_warm_ms"],
                         "decode_ms_per_token": lm["decode_ms_per_token"],
                         "decode_tokens_per_s": lm["decode_tokens_per_s"],
                         "peak_device_bytes": lm["peak_device_bytes"],
                         "b4_ms": timing["B4"]["ms"], "b5_ms": timing["B5"]["ms"],
                         "b5_ms_cuda_cores": timing["B5"]["ms_cuda_cores"]},
          "seconds": time.perf_counter() - t_start})
    kernels = []
    for name, key, source, replaces, count in (
        ("kernel_matmul (B1)", "B1", KERNEL_SOURCE,
         "src/repro/kernels/kernel_matmul/kernel_matmul.py:298",
         launches + train["B1"] + serve_mixed["B1"] + train_mixed["B1"] + multi["B1"]
         + serve_part["B1"] + train_part["B1"] + million["B1"] + _streamed(streaming, "B1")
         + mt_launches["multitask"]["B1"] + mt_launches["multitask_mixed"]["B1"]
         + zoo["gp_serve_zoo"]["B1"]),
        ("kernel_matmul batched (B2)", "B2", KERNEL_SOURCE,
         "src/repro/kernels/kernel_matmul/kernel_matmul.py:199", batched + multi["B2"]),
        ("fused_cg_step (B3)", "B3", FUSED_SOURCE,
         "src/repro/kernels/kernel_matmul/kernel_matmul.py:487",
         train["B3"] + multi["B3"] + train_part["B3"] + million["B3"]
         + _streamed(streaming, "B3")),
        ("kernel_matmul_grad (port-only VJP, 1 launch per symmetric VJP or row panel)", "grad",
         GRAD_SOURCE, "src/repro/core/inference.py:641 (jax.vjp, no TPU kernel)",
         train["grad"] + train_mixed["grad"] + multi["grad"] + train_part["grad"]
         + mt_launches["multitask"]["grad"] + mt_launches["multitask_mixed"]["grad"]
         + zoo["gp_serve_zoo"]["grad"]),
        ("kernel_matmul bf16 (B1, precision=mixed)", "B1_bf16", KERNEL_BF16_SOURCE,
         "src/repro/kernels/kernel_matmul/kernel_matmul.py:298 (compute_dtype=bfloat16)",
         serve_mixed["B1_bf16"] + train_mixed["B1_bf16"] + multi["B1_bf16"]
         + train_part["B1_bf16"] + _streamed(streaming, "B1_bf16")
         + mt_launches["multitask_mixed"]["B1_bf16"] + zoo["gp_serve_zoo"]["B1_bf16"]),
        ("kernel_matmul bf16 batched (B2, precision=mixed)", "B2_bf16", KERNEL_BF16_SOURCE,
         "src/repro/kernels/kernel_matmul/kernel_matmul.py:199 (compute_dtype=bfloat16)",
         serve_mixed["B2_bf16"] + train_mixed["B2_bf16"] + multi["B2_bf16"]),
        ("fused_cg_step bf16 (B3, precision=mixed)", "B3_bf16", FUSED_BF16_SOURCE,
         "src/repro/kernels/kernel_matmul/kernel_matmul.py:487 (compute_dtype=bfloat16)",
         train_mixed["B3_bf16"] + multi["B3_bf16"] + train_part["B3_bf16"]
         + _streamed(streaming, "B3_bf16")),
        ("flash_attention (B4)", "B4", FLASH_SOURCE,
         "src/repro/kernels/flash_attention/flash_attention.py:83", lm["launches"]["B4"]),
        ("ssd_scan (B5, bf16 on the tensor-core route)", "B5", SSD_SOURCE,
         "src/repro/kernels/ssd_scan/ssd_scan.py:91", lm["launches"]["B5"]),
    ):
        row = timing[key]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": count, "max_abs_err": errs[key],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

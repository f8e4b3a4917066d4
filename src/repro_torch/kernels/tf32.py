"""TF32 arithmetic in plain torch, as the f32 tensor-core routes of B4 and
B5 run it on the card (``hopper/csrc/tf32_mma.cuh``): the plain mirrors in
``flash_attention/ref.py`` and ``ssd_scan/ref.py`` build on it."""

from __future__ import annotations

import torch


def tf32_round(x):
    """x (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest,
    ties away from zero, the 13 low mantissa bits cleared; inf and NaN as
    they are."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def tf32_split(x):
    """x (f32) as TF32 halves hi = tf32(x), lo = tf32(x − hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_matmul(a, b, *, passes=3):
    """a @ b (f32) as the tensor cores form it: with ``passes`` 3, the
    3xTF32 sum a_lo·b_hi + a_hi·b_lo + a_hi·b_hi of TF32 halves (a_lo·b_lo,
    below f32 rounding, dropped); with 1, one-pass TF32, tf32(a)·tf32(b),
    which keeps about three decimal digits (the routes never run it)."""
    if passes == 1:
        return tf32_round(a) @ tf32_round(b)
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh

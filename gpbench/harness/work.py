"""The algorithm's work, counted once from shapes, and the card's peaks.

A roofline share or an ``mfu`` is the least time the card could take for
the algorithm's work over the time measured.  The work is counted once,
whatever passes an implementation makes (three TF32 products for an f32
product count as one), and priced at the tensor-core peak of the cell's
precision, so no implementation can read above 100 %.

Per kernel-matrix entry (rows × cols of them): the distance 2d + 1
operations and the map (Matérn-5/2: 10); per right-hand-side column 2
operations an entry (multiply, add).  Bytes: every input read once and
every output written once, in float32.
"""

from __future__ import annotations

#: NVIDIA H100 SXM data sheet, dense: TF32 and bf16 tensor-core peaks,
#: HBM3 bandwidth
PEAK_FLOPS = {"highest": 495e12, "mixed": 989e12}
PEAK_BYTES = 3.35e12
MAP_FLOPS = {"rbf": 3, "matern12": 4, "matern32": 7, "matern52": 10}
#: the fused CG step's state prologue and its four reductions, per element
#: of the (n, t) state
STATE_FLOPS = 14


def tile_flops(rows: int, cols: int, d: int, kernel: str) -> float:
    return float(rows) * cols * (2 * d + 1 + MAP_FLOPS[kernel])


def b1(rows: int, cols: int, d: int, t: int, kernel: str):
    """(operations, bytes) of (K(X1, X2) + σ²I)·M, M (cols, t)."""
    ops = tile_flops(rows, cols, d, kernel) + 2.0 * rows * cols * t
    nbytes = 4.0 * ((rows + cols) * d + cols * t + rows * t)
    return ops, nbytes


def b3(n: int, d: int, t: int, kernel: str):
    """(operations, bytes) of one fused CG iteration over an (n, t) state:
    the state update, K̂·D and the four reductions."""
    ops = tile_flops(n, n, d, kernel) + 2.0 * n * n * t + STATE_FLOPS * n * t
    nbytes = 4.0 * (n * d + 8 * n * t + 7 * t)
    return ops, nbytes


def grad(n: int, d: int, t: int):
    """(operations, bytes) of the kernel matmul's vector-Jacobian product
    for X and the outputscale: per entry the differences and distance
    (3d), the map and its derivative (20), the weight (2t) and the two
    gradient sums (4d)."""
    ops = float(n) * n * (3 * d + 20 + 2 * t + 4 * d)
    nbytes = 4.0 * (n * d + 2 * n * t + 2 * n * d)
    return ops, nbytes


def query(n: int, s: int, d: int, m: int, kernel: str):
    """(operations, bytes) of one cached answer for s points: the cross
    covariance, the mean k*ᵀα, the projection v = basisᵀk* (m columns) and
    the Gram solve's two triangular passes."""
    ops = (tile_flops(n, s, d, kernel) + 2.0 * n * s + 2.0 * n * s * m
           + 2.0 * m * m * s + 2.0 * m * s)
    nbytes = 4.0 * ((n + s) * d + n + n * m + m * m + 2 * s)
    return ops, nbytes


def least_seconds(ops: float, nbytes: float, precision: str) -> float:
    return max(ops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES)

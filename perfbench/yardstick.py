"""The benchmark's yardstick: the card's peaks and what each kernel call
costs at the least.

The peaks are NVIDIA's data-sheet figures for one H100 SXM (80 GB HBM3)
at its full 700 W power limit, dense, without sparsity. A card set below
700 W runs slower under load, so every share of them is reported with the
card's power limit beside it.

A call's bound is the larger of its bytes over the memory rate and its
operations over their rates. Bytes count each input read once and each
output written once. An f32-exact distance product runs as three TF32
products (3xTF32), so a (row, centroid) pair costs ``3 * 2 * d`` TF32
operations; adds into sums are f32 operations on the CUDA cores. Where
the work depends on the data (rows a bound settled, rows of weight 0),
only what the inputs need is counted.

Plain Python: imports nothing of the program.
"""
from __future__ import annotations

#: HBM3 bytes a second
PEAK_BYTES_S = 3.35e12
#: f32 operations a second on the CUDA cores
PEAK_F32_FLOPS = 67e12
#: TF32 operations a second on the tensor cores, dense
PEAK_TF32_FLOPS = 495e12
#: TF32 operations of one (row, centroid, feature) in an f32-exact product
TF32_OPS_PER_MAC = 3 * 2.0


def bound_s(n_bytes: float, f32_flops: float = 0.0,
            tf32_flops: float = 0.0) -> float:
    """Least seconds for the work: the larger of the memory term and the
    compute term (f32 and TF32 operations add: one unit runs both)."""
    compute = f32_flops / PEAK_F32_FLOPS + tf32_flops / PEAK_TF32_FLOPS
    return max(n_bytes / PEAK_BYTES_S, compute)


def assign_top2(rows: int, k: int, d: int) -> float:
    """Kernel 1: x (rows, d) and c (k, d) in; a label and two distances
    (12 B) a row out; every row's top-2 over all k."""
    return bound_s(4.0 * rows * d + 4.0 * k * d + 12.0 * rows,
                   tf32_flops=TF32_OPS_PER_MAC * rows * k * d)


def cluster_sum(rows: int, k: int, d: int, weighted: bool,
                live_rows: int) -> float:
    """Kernel 2: the labels (and weights) of every row, the features of
    the ``live_rows`` of nonzero weight, S (k, d) and v (k,) out; one add
    (and one multiply where weighted) a live feature."""
    n_bytes = (4.0 * live_rows * d + 4.0 * rows * (2 if weighted else 1)
               + 4.0 * (k * d + k))
    return bound_s(n_bytes,
                   f32_flops=(2.0 if weighted else 1.0) * live_rows * d)


def fused_nested_round(rows: int, k: int, d: int, scanned: int) -> float:
    """Kernel 3: c and the per-row state in (a_prev, d_keep, lb_keep 4 B
    each, settled and valid 1 B each), a_new, d_new, lb_new out, dS, dv,
    sse out; the ``scanned`` rows that no bound settled are read and
    take a top-2 over all k."""
    n_bytes = (4.0 * scanned * d + 4.0 * k * d + 14.0 * rows + 12.0 * rows
               + 4.0 * (k * d + 2 * k))
    return bound_s(n_bytes, tf32_flops=TF32_OPS_PER_MAC * scanned * k * d)


def fused_round(rows: int, k: int, d: int) -> float:
    """Kernel 4: x once, c, a label and two distances a row out, S, v,
    sse out; every row's top-2 over all k and its d adds into S."""
    n_bytes = (4.0 * rows * d + 4.0 * k * d + 12.0 * rows
               + 4.0 * (k * d + 2 * k))
    return bound_s(n_bytes, f32_flops=1.0 * rows * d,
                   tf32_flops=TF32_OPS_PER_MAC * rows * k * d)


def model_flops(rows: int, k: int, d: int) -> float:
    """The algorithm's own operations for ``rows`` k-scans: one multiply
    and one add a (row, centroid, feature). An f32-exact implementation
    does three times as many, so ``mfu`` reads at most a third."""
    return 2.0 * rows * k * d

"""Weighted per-cluster sums: the CUDA kernel's wrapper.

Port of `repro/kernels/cluster_sum.py::cluster_sum_pallas`; the kernel is
``csrc/cluster_sum.cu`` and its plain version `ref.cluster_sum_ref`. The
kernel sums in the order of `ref.ordered_sums`, which gives its bits.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.plan import chunk_rows

#: launches of the CUDA kernel in this process
launches = 0
#: clusters per tile of the scatter's row lists (``SK`` in csrc/common.cuh)
SCATTER_TILE = 64


@functools.lru_cache(maxsize=None)
def _fn():
    return _build.bind("cluster_sum", "cluster_sum_f32", 6, 4)


def scatter_scratch(n: int, k: int, d: int, n_sums: int, slots: int,
                    device) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """(rows, partial, lists): the deterministic scatter's chunk size and
    scratch for n > 0 rows. ``partial`` holds each chunk's sums (k*d +
    n_sums*k floats a chunk); ``lists`` the count and offset of each
    (chunk, cluster tile) list, then ``slots`` list entries a row (2 for
    the nested round's signed rows, else 1)."""
    rows = chunk_rows(n)
    n_chunks = -(-n // rows)
    n_tiles = -(-k // SCATTER_TILE)
    partial = torch.empty(n_chunks * (k * d + n_sums * k),
                          dtype=torch.float32, device=device)
    lists = torch.empty(2 * n_chunks * n_tiles + slots * n,
                        dtype=torch.int32, device=device)
    return rows, partial, lists


def cluster_sum_cuda(x: torch.Tensor, a: torch.Tensor, k: int, *,
                     weights: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S (k, d) and v (k,) f32 on the card: rows of x (n, d) f32 scaled by
    ``weights`` (n,) f32 (default 1) and summed by label a (n,) int32.
    Labels outside [0, k) add nothing. d may be 0 (counts only).
    Deterministic: the same inputs give the same bits."""
    global launches
    if weights is None:
        weights = torch.ones(x.shape[0], dtype=torch.float32,
                             device=x.device)
    dev = _build.require_cuda(x, a, weights)
    if x.dtype != torch.float32 or a.dtype != torch.int32 \
            or weights.dtype != torch.float32:
        raise TypeError(f"cluster_sum takes f32 x, int32 a, f32 weights; "
                        f"got {x.dtype}, {a.dtype}, {weights.dtype}")
    n, d = x.shape
    if a.shape != (n,) or weights.shape != (n,) or k < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, weights {tuple(weights.shape)}"
                         f", k={k}")
    out = torch.zeros(k * d + k, dtype=torch.float32, device=dev)
    if n > 0:
        rows, partial, lists = scatter_scratch(n, k, d, 1, 1, dev)
        err = _fn()(x.data_ptr(), a.data_ptr(), weights.data_ptr(),
                    partial.data_ptr(), lists.data_ptr(), out.data_ptr(),
                    n, k, d, rows, _build.stream(dev))
        _build.check(err, "cluster_sum", "cluster_sum_f32")
        with _build.launch_lock:
            launches += 1
    return out[:k * d].view(k, d), out[k * d:]

"""Plain PyTorch versions of the kernels: the semantics every kernel is
held to.

Port of `repro/kernels/ref.py`. These run on any device. On the CPU they
are what the ops take; on the card the CUDA kernels are compared with
them (`chip_smoke.py`, `tests/test_torch_kernels.py`). Labels are int32,
as in the JAX package (`torch.argmin` gives int64).

Matrix products here are full float32: they rely on PyTorch's default
`torch.backends.cuda.matmul.allow_tf32 == False`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def pairwise_dist2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances, (n, k) f32, for x (n, d) and c (k, d):
    ``max(|x|^2 - 2 x.c + |c|^2, 0)``."""
    x = x.float()
    c = c.float()
    xn = torch.einsum("nd,nd->n", x, x)[:, None]
    cn = torch.einsum("kd,kd->k", c, c)[None, :]
    d2 = xn - 2.0 * (x @ c.T) + cn
    return torch.clamp_min(d2, 0.0)


def assign_top2_ref(x: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nearest index int32, min dist^2, 2nd-min dist^2) for each row.

    The lower index wins a tie; the 2nd-min is the min over every index
    but the argmin, so a duplicate of the min counts. k == 1 gives +inf
    as the second distance.
    """
    d2 = pairwise_dist2(x, c)
    a = torch.argmin(d2, dim=1)
    d1 = torch.gather(d2, 1, a[:, None])[:, 0]
    if c.shape[0] == 1:
        d_2nd = torch.full_like(d1, float("inf"))
    else:
        masked = torch.scatter(d2, 1, a[:, None], float("inf"))
        d_2nd = torch.min(masked, dim=1).values
    return a.to(torch.int32), d1, d_2nd


def cluster_sum_ref(x: torch.Tensor, a: torch.Tensor, k: int, *,
                    weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums S (k, d) and counts v (k,) of x grouped by a,
    each row scaled by ``weights`` (default 1). Labels must lie in
    [0, k)."""
    x = x.float()
    if weights is None:
        weights = torch.ones(x.shape[0], dtype=torch.float32,
                             device=x.device)
    weights = weights.float()
    idx = a.long()
    s = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    s.index_add_(0, idx, x * weights[:, None])
    v = torch.zeros((k,), dtype=torch.float32, device=x.device)
    v.index_add_(0, idx, weights)
    return s, v

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

from repro_torch.kernels.plan import chunk_rows


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


#: elements (rows x k) of one block's one-hot matrix in `onehot_sums`
ONEHOT_BLOCK = 1 << 24


def cluster_sum_ref(x: torch.Tensor, a: torch.Tensor, k: int, *,
                    weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster sums S (k, d) and counts v (k,) of x grouped by a,
    each row scaled by ``weights`` (default 1). Labels must lie in
    [0, k).

    On the CPU by ``index_add_``. On a CUDA device by `onehot_sums`:
    ``index_add_`` adds there with atomics in no fixed order, and two
    runs would differ in the last bits."""
    if x.device.type == "cuda":
        return onehot_sums(x, a, k, weights=weights)
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


def onehot_sums(x: torch.Tensor, a: torch.Tensor, k: int, *,
                weights: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`cluster_sum_ref`'s S and v in a fixed order, on any device: the
    rows in blocks of ``ONEHOT_BLOCK // k``, each block one matrix
    product of its weighted one-hot labels (rows, k) with its rows of x,
    the blocks added in block order. A product has no atomics, so the
    same inputs give the same bits; the one-hot matrix holds at most
    ``ONEHOT_BLOCK`` floats (64 MB) at any k; and each entry is a sum of
    products, not a difference of prefix sums, so nothing cancels."""
    x = x.float()
    n, d = x.shape
    w = (torch.ones(n, dtype=torch.float32, device=x.device)
         if weights is None else weights.float())
    ids = torch.arange(k, device=x.device)
    s = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    v = torch.zeros((k,), dtype=torch.float32, device=x.device)
    rows = max(1, ONEHOT_BLOCK // k)
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        onehot = (a[lo:hi, None].long() == ids).float() * w[lo:hi, None]
        s += onehot.T @ x[lo:hi]
        v += onehot.sum(dim=0)
    return s, v


def ordered_sums(x: torch.Tensor, k: int, a: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None, *,
                 a_prev: Optional[torch.Tensor] = None,
                 a_new: Optional[torch.Tensor] = None,
                 d_new: Optional[torch.Tensor] = None,
                 d1sq: Optional[torch.Tensor] = None):
    """The deterministic scatter's sums in the kernels' own order: the
    order oracle of ``csrc/common.cuh``. Not on any path; the tests and
    ``chip_smoke.py`` hold the kernels to it bit for bit.

    Three modes, as the kernels take them:

    * ``a`` and ``weights`` (default 1): (S, v), row r adding w[r] x[r]
      and w[r] at a[r] where w[r] != 0 and 0 <= a[r] < k
      (`cluster_sum`);
    * ``a_prev``, ``a_new``, ``d_new``: (dS, dv, sse), +x and +1 at a_new
      for joins and new rows, -x and -1 at a_prev for leaves, d_new^2 at
      a_new clamped to [0, k) for every row (the nested round);
    * ``a`` and ``d1sq``: (S, v, sse), x and 1 and d1sq at a (the one-shot
      round).

    The order: rows in chunks of ``plan.chunk_rows(n)``; within a chunk,
    row by row in row order, each add ``acc + w * x`` in f32 with the
    product rounded first (the kernels' FMA gives the same bits for w in
    {-1, 0, 1}, which is all the main path uses); then the chunks, in
    chunk order, from +0. Each step adds row p of every chunk at once
    with ``index_add_`` at indices that differ, so it is exact on any
    device.
    """
    x = x.float()
    n, d = x.shape
    dev = x.device
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    nothing = torch.full((n,), k, dtype=torch.long, device=dev)
    sse = None
    if a_new is not None:
        ap, an = a_prev.long(), a_new.long()
        seen = ap >= 0
        changed = seen & (an != ap)
        joins = (changed | ~seen) & (an >= 0)
        terms = [(torch.where(joins, an.clamp(0, k - 1), nothing), ones),
                 (torch.where(changed, ap.clamp(0, k - 1), nothing), -ones)]
        d_new = d_new.float()
        sse = (an.clamp(0, k - 1), d_new * d_new)
    else:
        a = a.long()
        inside = (a >= 0) & (a < k)
        if d1sq is not None:
            at = torch.where(inside, a, nothing)
            terms = [(at, ones)]
            sse = (at, d1sq.float())
        else:
            w = ones if weights is None else weights.float()
            terms = [(torch.where(inside & (w != 0), a, nothing), w)]
    # per chunk: k clusters and one slot for adds that go nowhere
    rows = chunk_rows(max(n, 1))
    n_chunks = -(-n // rows)
    S = torch.zeros(n_chunks * (k + 1), d, dtype=torch.float32, device=dev)
    v = torch.zeros(n_chunks * (k + 1), dtype=torch.float32, device=dev)
    e = torch.zeros_like(v)
    first = torch.arange(n_chunks, device=dev) * rows
    slot = torch.arange(n_chunks, device=dev) * (k + 1)
    for p in range(min(rows, n)):
        r = first + p
        keep = r < n
        r, at = r[keep], slot[keep]
        for idx, w in terms:
            S.index_add_(0, at + idx[r], x[r] * w[r, None])
            v.index_add_(0, at + idx[r], w[r])
        if sse is not None:
            e.index_add_(0, at + sse[0][r], sse[1][r])
    out = [S.view(n_chunks, k + 1, d)[:, :k], v.view(n_chunks, k + 1)[:, :k],
           e.view(n_chunks, k + 1)[:, :k]]
    sums = []
    for part in out[:2] if sse is None else out:
        total = torch.zeros(part.shape[1:], dtype=torch.float32,
                            device=dev)
        for ch in range(n_chunks):
            total += part[ch]
        sums.append(total)
    return tuple(sums)

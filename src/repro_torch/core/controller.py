"""The paper's dynamic batch-growth controller (Algorithm 6).

Port of `repro/core/controller.py`. ``sigma_C(j) = sqrt(sse(j) / (v(j)
(v(j)-1)))`` estimates the stochastic error of centroid j's position;
``p(j)`` is the progress it made last round. The batch doubles when the
median ratio sigma_C/p reaches rho.

Degenerate cases, following the paper:
  * ``p(j) == 0``   -> ratio +inf (cluster j finished moving).
  * ``v(j) <= 1``   -> ratio +inf (no variance estimate possible).
  * ``rho == inf``  -> doubles iff the median ratio is +inf, i.e. MORE
                       THAN HALF the centroids did not move.

"median" is the lower median ``sorted[(k-1)//2]``, so with k even and
exactly half the ratios infinite the batch does NOT double.
"""
from __future__ import annotations

from typing import Tuple

import torch

_INF = float("inf")


def sigma_c(sse: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-cluster stochastic-error estimate; +inf where v <= 1.

    The v(v-1) denominator is substituted (never clamped) where the
    estimate is undefined, so 1 < v < 2 keeps its true denominator in
    (0, 2).
    """
    live = v > 1.0
    safe = torch.where(live, v * (v - 1.0), torch.ones_like(v))
    return torch.where(live, torch.sqrt(sse / safe),
                       torch.full_like(v, _INF))


def growth_ratios(sse: torch.Tensor, v: torch.Tensor,
                  p: torch.Tensor) -> torch.Tensor:
    sig = sigma_c(sse, v)
    return torch.where(p > 0.0, sig / torch.clamp_min(p, 1e-30),
                       torch.full_like(p, _INF))


def lower_median(x: torch.Tensor) -> torch.Tensor:
    k = x.shape[0]
    return torch.sort(x).values[(k - 1) // 2]


def should_grow(sse: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
                rho: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grow: bool 0-d tensor, r: median ratio). rho may be inf: r >= inf
    holds only when r == inf."""
    r = lower_median(growth_ratios(sse, v, p))
    return r >= rho, r

"""K-means state as frozen dataclasses of tensors.

Port of `repro/core/state.py`. Distances are EUCLIDEAN everywhere in the
state; kernels return squared distances and the rounds take the sqrt
once per recomputation.

Conventions:
  * ``a == -1``  -> point never assigned (not yet in the nested batch).
  * per-point tensors are allocated at full N; the nested algorithms
    touch only the active prefix ``[:b]``.
  * every tensor of a state lies on the device of the data it came from.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ref


@dataclasses.dataclass(frozen=True)
class ClusterStats:
    """Per-cluster running statistics."""
    C: torch.Tensor       # (k, d) f32 centroids
    S: torch.Tensor       # (k, d) f32 sums
    v: torch.Tensor       # (k,)  f32 assignment counts
    sse: torch.Tensor     # (k,)  f32 sum of squared distances of members
    p: torch.Tensor       # (k,)  f32 distance moved in the last update


@dataclasses.dataclass(frozen=True)
class PointState:
    """Per-point state. Tensors are full-N; nested algorithms touch [:b]."""
    a: torch.Tensor       # (N,) int32 last assignment, -1 = never assigned
    d: torch.Tensor       # (N,) f32 distance at last (re)computation
    lb: torch.Tensor      # (N,) f32 lower bound on the 2nd-nearest distance
                          #      (hamerly2 and exponion; elkan leaves it)


@dataclasses.dataclass(frozen=True)
class ElkanBounds:
    """Per-(point, centroid) lower bounds of ``bounds="elkan"``."""
    l: torch.Tensor       # (N, k) f32


@dataclasses.dataclass(frozen=True)
class ExponionGeom:
    """Inter-centroid geometry of ``bounds="exponion"``, rebuilt each
    round from the centroids (never part of the state).

      order  (k, k) int32  each anchor's centroids sorted by distance
      dist   (k, k) f32    the matching sorted euclidean distances
      rank   (k, k) int32  inverse permutation: ``rank[j, c]`` is c's
                           position around anchor j
      s      (k,)   f32    distance to the nearest other centroid
                           (``dist[:, 1]``; 0 at k = 1)
    """
    order: torch.Tensor
    dist: torch.Tensor
    rank: torch.Tensor
    s: torch.Tensor


def build_exponion_geom(C: torch.Tensor) -> ExponionGeom:
    """Sorted inter-centroid neighbour table for the exponion family.

    Both sorts are stable, as ``jnp.argsort`` is: tied distances (as
    between duplicate centroids) keep their index order, so ``rank``
    and the ring masks built on it are the JAX package's.
    """
    k = C.shape[0]
    d2 = ref.pairwise_dist2(C, C)
    # the self-distance sorts first with an exact 0 (the matrix product
    # can leave rounding dust on the diagonal)
    d2.fill_diagonal_(0.0)
    dist_full = torch.sqrt(torch.clamp_min(d2, 0.0))
    order = torch.argsort(dist_full, dim=1, stable=True)
    dist = torch.take_along_dim(dist_full, order, dim=1)
    rank = torch.argsort(order, dim=1, stable=True)
    s = (dist[:, 1] if k > 1
         else torch.zeros((k,), dtype=torch.float32, device=C.device))
    return ExponionGeom(order=order.to(torch.int32), dist=dist,
                        rank=rank.to(torch.int32), s=s)


@dataclasses.dataclass(frozen=True)
class KMeansState:
    stats: ClusterStats
    points: PointState
    elkan: Optional[ElkanBounds]   # only for bounds="elkan"
    round: torch.Tensor   # () int32


@dataclasses.dataclass(frozen=True)
class RoundInfo:
    """Telemetry returned by every round function (all 0-d tensors)."""
    batch_mse: torch.Tensor     # mean d^2 over the active batch
    n_changed: torch.Tensor     # assignments that changed this round
    n_recomputed: torch.Tensor  # points whose distances were recomputed
    n_active: torch.Tensor      # active batch size (real rows only)
    overflow: torch.Tensor      # bool: capacity < points needing recompute
    grow: torch.Tensor          # bool: controller voted to double b
    r_median: torch.Tensor      # median sigma_C/p ratio (controller stat)
    p_max: torch.Tensor         # max centroid movement after the update


def init_state(X: torch.Tensor, k: int, *, bounds: str = "hamerly2",
               init_idx: Optional[torch.Tensor] = None) -> KMeansState:
    """Paper initialisation: the first k points of the (shuffled) data.

    ``init_idx`` overrides with explicit centroid row indices. Only
    ``bounds="elkan"`` allocates the (N, k) per-pair bounds.
    """
    n, d = X.shape
    dev = X.device
    C0 = (X[:k] if init_idx is None else X[init_idx]).float().clone()
    zeros_k = torch.zeros((k,), dtype=torch.float32, device=dev)
    stats = ClusterStats(
        C=C0, S=torch.zeros((k, d), dtype=torch.float32, device=dev),
        v=zeros_k, sse=zeros_k.clone(), p=zeros_k.clone())
    points = PointState(
        a=torch.full((n,), -1, dtype=torch.int32, device=dev),
        d=torch.zeros((n,), dtype=torch.float32, device=dev),
        lb=torch.zeros((n,), dtype=torch.float32, device=dev))
    elkan = (ElkanBounds(l=torch.zeros((n, k), dtype=torch.float32,
                                       device=dev))
             if bounds == "elkan" else None)
    return KMeansState(stats=stats, points=points, elkan=elkan,
                       round=torch.zeros((), dtype=torch.int32, device=dev))


def centroid_update(stats: ClusterStats) -> ClusterStats:
    """C <- S/v (an empty cluster keeps its centroid); p <- ||dC||."""
    safe_v = torch.clamp_min(stats.v, 1.0)
    C_new = torch.where((stats.v > 0.0)[:, None], stats.S / safe_v[:, None],
                        stats.C)
    p = torch.sqrt(torch.sum((C_new - stats.C) ** 2, dim=1))
    return dataclasses.replace(stats, C=C_new, p=p)


def full_mse(X: torch.Tensor, C: torch.Tensor, *,
             chunk: int = 65536) -> torch.Tensor:
    """Validation-set MSE: mean squared distance to the nearest centroid.

    Chunked over points so a large validation set never materialises an
    (n, k) distance matrix. The chunk sums are added in order in f32, as
    the JAX version's scan does; the ragged last chunk is sliced, so the
    JAX version's pad correction has nothing to correct here.
    """
    n = X.shape[0]
    total = torch.zeros((), dtype=torch.float32, device=X.device)
    for lo in range(0, n, chunk):
        d2 = ref.pairwise_dist2(X[lo:lo + chunk], C)
        total = total + torch.sum(torch.min(d2, dim=1).values)
    return total / n

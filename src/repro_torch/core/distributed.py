"""Distributed nested mini-batch k-means on torch.distributed.

Port of `repro/core/distributed.py`. JAX runs each round body under
``shard_map`` over a `Mesh`; here every rank runs the body on its own
rows, as the body of a ``shard_map`` sees them, and the psums and
all-gathers over named mesh axes are collectives over the process groups
of a `DeviceMesh`'s named dims (`core/collectives.py`). The layout is
JAX's:

  * points row-sharded over the data dims. Each rank holds a contiguous
    slice of the PRE-SHUFFLED dataset, so the nested-prefix property
    holds per rank and the global batch of size b is the union of the
    per-rank prefixes of size b / n_shards.
  * cluster stats replicated. The S/v/sse deltas are all-reduced inside
    the round (`rounds.nested_round(mesh=..., data_axes=...)`), so the
    stats, the centroids and the growth decision are the same bits on
    every rank.
  * for very large k the centroids are also sharded over "model": each
    model rank scans its k-slice, and the per-rank (d1, d2, index)
    triples are all-gathered over "model" and folded.

``mesh=None`` is the single-device form: no collective runs, as a psum
over a one-device mesh is the identity.

`shard_state` takes this rank's rows of a full state, and
`fit_distributed` is the JAX package's deprecated entry point, a shim
over `repro_torch.api` and the mesh engine. `shard_map_compat` has no
counterpart: a rank runs its body directly.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import collectives, controller, rounds
from repro_torch.core.state import (ClusterStats, KMeansState, PointState,
                                    centroid_update)
from repro_torch.kernels import ops
from repro_torch.kernels.plan import KernelPlan


# --------------------------------------------------------------------------
# replicated-centroid engine (paper-scale k)
# --------------------------------------------------------------------------

def per_shard_n_valid(mesh, data_axes: Tuple[str, ...],
                      n_real: Optional[int]) -> Optional[int]:
    """This rank's real-row cap (or None).

    The rank's linear index is row-major over ``data_axes``, the slice
    order of JAX's ``P(data_axes, None)``. The up-to-``n_shards - 1``
    tail rows of a non-divisible ``n_real`` land on the low ranks.
    """
    if n_real is None:
        return None
    n_shards = 1
    for ax in data_axes:
        n_shards *= collectives.axis_size(mesh, ax)
    base, rem = divmod(n_real, n_shards)
    return base + int(collectives.linear_index(mesh, data_axes) < rem)


def make_sharded_round(mesh, data_axes: Tuple[str, ...], *, b_local: int,
                       rho: float, bounds: str = "hamerly2",
                       capacity: Optional[int] = None,
                       use_shalf: bool = True,
                       n_real: Optional[int] = None,
                       plan: Optional[KernelPlan] = None):
    """The nested round over this rank's rows: ``fn(X_local, state) ->
    (state, info)``, with the stats all-reduced over ``data_axes``.

    ``n_real``: global count of real (non-pad) rows. Each rank caps its
    active prefix at its own share (`per_shard_n_valid`), so every real
    row, and no pad, enters the final full batch. ``None`` keeps the
    unmasked round.
    """
    return functools.partial(
        rounds.nested_round, b=b_local, rho=rho, bounds=bounds,
        capacity=capacity, use_shalf=use_shalf, plan=plan,
        n_valid=per_shard_n_valid(mesh, tuple(data_axes), n_real),
        mesh=mesh, data_axes=tuple(data_axes))


def shard_state(state: KMeansState, mesh,
                data_axes: Tuple[str, ...]) -> KMeansState:
    """This rank's share of a full state, in the engine's layout: the
    rank's contiguous slice of the per-point leaves (row-major over
    ``data_axes``, as `P(data_axes)` slices them), the stats and the
    round replicated. The rows must divide evenly over the shards. As in
    JAX, the elkan bounds are not carried."""
    data_axes = tuple(data_axes)
    n_shards = 1
    for ax in data_axes:
        n_shards *= collectives.axis_size(mesh, ax)
    n = state.points.a.shape[0]
    if n % n_shards:
        raise ValueError(f"{n} rows do not divide over {n_shards} shards")
    per = n // n_shards
    lo = collectives.linear_index(mesh, data_axes) * per
    rows = slice(lo, lo + per)
    points = PointState(a=state.points.a[rows].clone(),
                        d=state.points.d[rows].clone(),
                        lb=state.points.lb[rows].clone())
    return KMeansState(stats=state.stats, points=points, elkan=None,
                       round=state.round)


def fit_distributed(X, k: int, mesh, *,
                    data_axes: Tuple[str, ...] = ("data",),
                    rho: float = float("inf"), b0: int = 5000,
                    bounds: str = "hamerly2", max_rounds: int = 1000,
                    seed: int = 0, use_shalf: bool = True, on_round=None,
                    device="cuda"):
    """DEPRECATED multi-rank entry point: a shim over `repro_torch.api`.

    Port of `repro/core/distributed.py::fit_distributed`: the historical
    signature and dict telemetry over `api.fit` with ``backend="mesh"``.
    Every rank calls it with the same arguments. The pre-api sharded
    loop used a smaller capacity floor and declared convergence on the
    first quiet round, and so does this shim."""
    from repro_torch import api
    from repro_torch.core.driver import FitResult

    config = api.FitConfig(
        k=k, algorithm="tb", rho=rho, b0=b0, bounds=bounds,
        max_rounds=max_rounds, seed=seed, use_shalf=use_shalf,
        backend="mesh", data_axes=tuple(data_axes), capacity_floor=256,
        converge_patience=1)
    cb = (lambda rec: on_round(rec.to_dict())) if on_round else None
    out = api.fit(X, config, mesh=mesh, on_round=cb, device=device)
    return FitResult.from_outcome(out, algorithm=f"tb-dist[{bounds}]")


# --------------------------------------------------------------------------
# sharded-centroid assignment (k over "model") — the kmeans_xl path
# --------------------------------------------------------------------------

def _fold_top2(d1a, d2a, ia, d1b, d2b, ib):
    """Combine two (min, 2nd-min, argmin) triples.

    Ties on the minimum break toward the LOWER global index, which makes
    the fold associative and commutative: tree folds, sequential folds
    and a single-device argmin over the concatenated centroids all pick
    the same winner, so the rank count never changes an assignment.
    """
    take_b = (d1b < d1a) | ((d1b == d1a) & (ib < ia))
    new1 = torch.minimum(d1a, d1b)
    newi = torch.where(take_b, ib, ia)
    new2 = torch.minimum(torch.maximum(d1a, d1b), torch.minimum(d2a, d2b))
    return new1, new2, newi


def _tree_fold(fold, *rows):
    """Fold (m, b) stacks pairwise in a log-depth tree, an odd tail row
    carried over, down to one (b,) row each: ``fold`` takes the rows of
    two halves and returns the folded rows."""
    while rows[0].shape[0] > 1:
        half = rows[0].shape[0] // 2
        out = fold(*(r[:half] for r in rows),
                   *(r[half:2 * half] for r in rows))
        if rows[0].shape[0] % 2:
            out = tuple(torch.cat([o, r[2 * half:]])
                        for o, r in zip(out, rows))
        rows = out
    return tuple(r[0] for r in rows)


def assign_top2_sharded(x: torch.Tensor, C_local: torch.Tensor, *, mesh,
                        model_axis: str, k_offset: int,
                        plan: Optional[KernelPlan] = None):
    """Top-2 nearest over model-sharded centroids.

    Each model rank scans its (k_local, d) slice, then the per-rank
    triples are all-gathered over ``model_axis`` and combined with a
    log-depth tree fold. Returns ``(a, d1_sq, d2_sq)`` with GLOBAL
    centroid indices and SQUARED distances, the units of
    `ops.assign_top2`. Ties on the minimum resolve to the lowest global
    index, as an argmin over the unsharded centroids does.
    """
    a_loc, d1_loc, d2_loc = ops.assign_top2(x, C_local, plan=plan)
    d1, d2, a = _tree_fold(
        _fold_top2, collectives.all_gather(d1_loc, mesh, model_axis),
        collectives.all_gather(d2_loc, mesh, model_axis),
        collectives.all_gather(a_loc + k_offset, mesh, model_axis))
    return a.to(torch.int32), d1, d2


def _centroid_step(S, v, sse, C):
    """(C_new, p) of `centroid_update`: S/v where a cluster has members."""
    new = centroid_update(ClusterStats(C=C, S=S, v=v, sse=sse,
                                       p=torch.zeros_like(v)))
    return new.C, new.p


def _count(x: torch.Tensor) -> torch.Tensor:
    """x's row count as a 0-d int64 tensor, filled on its device (no host
    copy, no wait for the stream)."""
    return torch.full((), x.shape[0], dtype=torch.int64, device=x.device)


def xl_round_body(x, C_local, S_local, v_local, *, k: int, mesh,
                  data_axes: Tuple[str, ...] = ("data",),
                  model_axis: str = "model", rho: float = float("inf")):
    """One production round with points sharded over the data dims AND
    centroids sharded over the model dim (the kmeans_xl dry-run step).

    Stateless-bounds variant (first / dense round): exhaustive sharded
    top-2 and fresh S/v (``S_local`` and ``v_local`` are not read, as in
    JAX). Returns the updated local centroid slice and telemetry
    ``(C_new, S_new, v_new, a, d, d2, grow, r_med, mse)``; ``d`` and
    ``d2`` are EUCLIDEAN.
    """
    k_local = C_local.shape[0]
    k_offset = collectives.axis_index(mesh, model_axis) * k_local
    a, d1, d2sq = assign_top2_sharded(x, C_local, mesh=mesh,
                                      model_axis=model_axis,
                                      k_offset=k_offset)
    d = torch.sqrt(torch.clamp_min(d1, 0.0))
    d2 = torch.sqrt(torch.clamp_min(d2sq, 0.0))

    # x and the folded a are replicated over the model dim, so each model
    # rank's full-k partial already agrees across it: slice out the local
    # k-range and reduce only that over the data dims
    S_full, v_full = ops.cluster_sum(x, a, k)
    sse_full = rounds.segment_sum(d * d, a, k)
    lo, hi = k_offset, k_offset + k_local
    S_new, v_new, sse_new, num, cnt = collectives.psum(
        (S_full[lo:hi], v_full[lo:hi], sse_full[lo:hi], torch.sum(d * d),
         _count(x)), mesh, data_axes)

    C_new, p_local = _centroid_step(S_new, v_new, sse_new, C_local)
    # the growth controller needs the global per-cluster stats
    p_all, v_all, sse_all = (
        collectives.all_gather(t, mesh, model_axis).reshape(-1)
        for t in (p_local, v_new, sse_new))
    grow, r_med = controller.should_grow(sse_all, v_all, p_all, rho=rho)
    return C_new, S_new, v_new, a, d, d2, grow, r_med, num / cnt.float()


def dp_round_body(x, C, *, mesh, data_axes: Tuple[str, ...],
                  rho: float = float("inf"), fused: bool = False):
    """Optimized production round: pure data parallelism, C replicated.

    Points are sharded over every mesh dim and C is replicated; the only
    collective is the (k, d) all-reduce of S/v/sse. ``fused`` runs the
    whole local round as one kernel (`ops.fused_round`, whose top-2 is
    taken on the partial distance); otherwise `ops.assign_top2` then
    `ops.cluster_sum`. Returns ``(C_new, S, v, a, d, grow, r_med, mse)``
    with ``d`` EUCLIDEAN.
    """
    k = C.shape[0]
    if fused:
        a, d1, _, S_loc, v_loc, sse_loc = ops.fused_round(x, C)
    else:
        a, d1, _ = ops.assign_top2(x, C)
        S_loc, v_loc = ops.cluster_sum(x, a, k)
        sse_loc = rounds.segment_sum(d1, a, k)
    d = torch.sqrt(torch.clamp_min(d1, 0.0))
    S, v, sse, num, cnt = collectives.psum(
        (S_loc, v_loc, sse_loc, torch.sum(d * d), _count(x)), mesh,
        data_axes)
    C_new, p = _centroid_step(S, v, sse, C)
    grow, r_med = controller.should_grow(sse, v, p, rho=rho)
    return C_new, S, v, a, d, grow, r_med, num / cnt.float()


def make_dp_round(mesh=None, *, rho: float = float("inf"),
                  fused: bool = False):
    """The data-parallel round over ALL mesh dims: ``fn(x_local, C)``.

    ``mesh=None`` runs it on one device with no collective."""
    axes = () if mesh is None else tuple(mesh.mesh_dim_names)
    return functools.partial(dp_round_body, mesh=mesh, data_axes=axes,
                             rho=rho, fused=fused)


def make_xl_round(mesh=None, *, k: int,
                  data_axes: Tuple[str, ...] = ("data",),
                  model_axis: str = "model", rho: float = float("inf")):
    """The centroid-sharded round: ``fn(x_local, C_local, S_local,
    v_local)``, for k too large to replicate; for kmeans_xl (k=4096) the
    data-parallel `make_dp_round` is the production round."""
    return functools.partial(xl_round_body, k=k, mesh=mesh,
                             data_axes=tuple(data_axes),
                             model_axis=model_axis, rho=rho)

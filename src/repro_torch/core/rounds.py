"""One-round update functions for every algorithm of the paper.

Port of `repro/core/rounds.py`. Each function takes a state and returns
a new one (the caller's tensors are never written) with its `RoundInfo`:

  * ``lloyd_round``   Lloyd's algorithm (full batch, fresh means);
  * ``mb_round``      Sculley's mini-batch in its S/v form, and with
                      ``fixed=True`` mb-f (``mbf_round``): the batch's
                      previous contributions are removed first;
  * ``nested_round``  gb-rho / tb-rho on the nested prefix ``X[:b]``,
                      by bound family: ``"none"`` (gb: every active
                      point scans all k), ``"hamerly2"`` (two bounds a
                      point plus capacity compaction), ``"elkan"`` (one
                      bound a (point, centroid) pair) and ``"exponion"``
                      (the Hamerly test plus annular candidate pruning).

Every bound family is exact: a bound test only skips work that provably
cannot change an assignment. The bound DECISIONS stay here in plain torch
(`_hamerly_settled`, `_assign_elkan`, `_assign_exponion`), as the JAX
package keeps them out of its kernels, so the schedule cannot drift
between the plain and the kernel path; elkan's and exponion's (b, k)
distances are plain matrix products (`ref.pairwise_dist2`), as there.
Per-cluster float sums go through `ops.cluster_sum`, whose kernel is
deterministic (a CUDA `index_add_` adds with atomics in no fixed order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import collectives, controller
from repro_torch.core.state import (ElkanBounds, KMeansState, RoundInfo,
                                   build_exponion_geom, centroid_update)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.plan import KernelPlan
from repro_torch.util import tracecount

INF = float("inf")


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _euclid(d2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(d2, 0.0))


def _dist_to_assigned(x: torch.Tensor, C: torch.Tensor,
                      a: torch.Tensor) -> torch.Tensor:
    """Exact euclidean distance of each point to its assigned centroid."""
    Cg = C[a.clamp(0, C.shape[0] - 1).long()]
    return _euclid(torch.sum((x.float() - Cg) ** 2, dim=1))


def _half_intercentroid(C: torch.Tensor) -> torch.Tensor:
    """Hamerly's s(j): half the distance to the nearest other centroid."""
    d2 = ref.pairwise_dist2(C, C)
    d2.fill_diagonal_(float("inf"))
    return 0.5 * _euclid(torch.min(d2, dim=1).values)


def segment_sum(vals: torch.Tensor, ids: torch.Tensor, k: int,
                plan: Optional[KernelPlan] = None) -> torch.Tensor:
    """Per-cluster sum of a per-row scalar: the counts output of
    `ops.cluster_sum` over zero feature columns, weighted by ``vals``."""
    _, v = ops.cluster_sum(vals.new_empty((vals.shape[0], 0)),
                           ids.clamp(0, k - 1), k, weights=vals, plan=plan)
    return v


def _delta_sv(x: torch.Tensor, a_prev: torch.Tensor, a_new: torch.Tensor,
              k: int, plan: Optional[KernelPlan]):
    """The nested S,v delta: remove expired, add current. Rows with
    ``a_new == -1`` (masked out of the active prefix) contribute
    nothing."""
    seen = a_prev >= 0
    changed = seen & (a_new != a_prev)
    w_rm = changed.float()
    w_add = ((changed | ~seen) & (a_new >= 0)).float()
    S_rm, v_rm = ops.cluster_sum(x, a_prev.clamp(0, k - 1), k,
                                 weights=w_rm, plan=plan)
    S_add, v_add = ops.cluster_sum(x, a_new.clamp(0, k - 1), k,
                                   weights=w_add, plan=plan)
    return S_add - S_rm, v_add - v_rm


def _refresh_sse(d_act: torch.Tensor, a_act: torch.Tensor, k: int,
                 plan: Optional[KernelPlan]) -> torch.Tensor:
    """sse(j) = sum of d(i)^2 over active members (exact, no staleness)."""
    return segment_sum(d_act * d_act, a_act, k, plan)


def _scalar(x, like: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """A 0-d tensor on ``like``'s device, filled there: `torch.tensor`
    would copy it from the host and wait for the stream."""
    return torch.full((), x, dtype=dtype, device=like.device)


def _no_growth_info(d: torch.Tensor, n_changed: torch.Tensor,
                    stats) -> RoundInfo:
    """The `RoundInfo` of a round outside the nested family: every row
    of ``d`` recomputed and active, no overflow, no growth vote."""
    n = _scalar(d.shape[0], d)
    return RoundInfo(
        batch_mse=torch.mean(d * d), n_changed=n_changed, n_recomputed=n,
        n_active=n, overflow=_scalar(False, d, torch.bool),
        grow=_scalar(False, d, torch.bool),
        r_median=_scalar(INF, d, torch.float32), p_max=torch.max(stats.p))


# --------------------------------------------------------------------------
# Lloyd
# --------------------------------------------------------------------------

def lloyd_round(X: torch.Tensor, state: KMeansState, *,
                plan: Optional[KernelPlan] = None
                ) -> Tuple[KMeansState, RoundInfo]:
    """Exact Lloyd iteration: full reassignment + fresh means."""
    k = state.stats.C.shape[0]
    a_new, d1sq, _ = ops.assign_top2(X, state.stats.C, plan=plan)
    d = _euclid(d1sq)
    S, v = ops.cluster_sum(X, a_new, k, plan=plan)
    sse = _refresh_sse(d, a_new, k, plan)
    stats = centroid_update(dataclasses.replace(state.stats, S=S, v=v,
                                                sse=sse))
    n_changed = (a_new != state.points.a).sum(dtype=torch.int32)
    points = dataclasses.replace(state.points, a=a_new, d=d)
    new_state = dataclasses.replace(state, stats=stats, points=points,
                                    round=state.round + 1)
    return new_state, _no_growth_info(d, n_changed, stats)


# --------------------------------------------------------------------------
# Mini-Batch (Sculley) and mb-f
# --------------------------------------------------------------------------

def mb_round(X: torch.Tensor, idx: torch.Tensor, state: KMeansState, *,
             fixed: bool, plan: Optional[KernelPlan] = None
             ) -> Tuple[KMeansState, RoundInfo]:
    """One round of mb (the S/v form of Sculley's algorithm) or, with
    ``fixed=True``, mb-f (each batch row's previous contribution is
    removed before its new one is added).

    ``idx``: (b,) int64 row indices of this round's batch, on X's device
    (the engine cycles through a reshuffled permutation, so a batch holds
    no row twice).
    """
    k = state.stats.C.shape[0]
    x = X[idx]
    a_new, d1sq, _ = ops.assign_top2(x, state.stats.C, plan=plan)
    d = _euclid(d1sq)

    if fixed:
        a_prev = state.points.a[idx]
        dS, dv = _delta_sv(x, a_prev, a_new, k, plan)
        stats = dataclasses.replace(state.stats, S=state.stats.S + dS,
                                    v=state.stats.v + dv)
        n_changed = ((a_prev >= 0) & (a_new != a_prev)).sum(
            dtype=torch.int32)
    else:
        # plain mb never removes: every (re)assignment accumulates
        S_add, v_add = ops.cluster_sum(x, a_new, k, plan=plan)
        stats = dataclasses.replace(state.stats, S=state.stats.S + S_add,
                                    v=state.stats.v + v_add)
        n_changed = _scalar(idx.shape[0], x)

    stats = centroid_update(stats)
    a_all = state.points.a.clone()
    d_all = state.points.d.clone()
    a_all[idx] = a_new
    d_all[idx] = d
    points = dataclasses.replace(state.points, a=a_all, d=d_all)
    new_state = dataclasses.replace(state, stats=stats, points=points,
                                    round=state.round + 1)
    return new_state, _no_growth_info(d, n_changed, stats)


def mbf_round(X, idx, state, *, plan=None):
    return mb_round(X, idx, state, fixed=True, plan=plan)


# --------------------------------------------------------------------------
# nested rounds
# --------------------------------------------------------------------------

def _assign_exhaustive(x, state, valid, *, plan, assign_top2_fn=None):
    """bounds='none': full top-2 for every active point.

    ``assign_top2_fn`` lets the centroid-sharded engine inject its
    collective top-2 (`core.distributed_xl`); the schedule stays the
    same.
    """
    if assign_top2_fn is None:
        a_new, d1sq, d2sq = ops.assign_top2(x, state.stats.C, plan=plan)
    else:
        a_new, d1sq, d2sq = assign_top2_fn(x)
    n_rec = (_scalar(x.shape[0], x) if valid is None
             else valid.sum(dtype=torch.int32))
    return (a_new, _euclid(d1sq), _euclid(d2sq), n_rec,
            _scalar(False, x, torch.bool), None)


def _hamerly_settled(x, state, a_prev, valid, *, use_shalf: bool,
                     p_max: Optional[torch.Tensor] = None,
                     d_assigned: Optional[torch.Tensor] = None,
                     s_half: Optional[torch.Tensor] = None):
    """The Hamerly bound DECISIONS for one round's active slice.

    Whatever executes the assignment, the settled mask (and so the bound
    and compaction schedule) comes from this one function. ``p_max``,
    ``d_assigned`` and ``s_half`` override the largest centroid move,
    the distances to the assigned centroids and the half inter-centroid
    distances: exponion reads s/2 off its geometry, and the
    centroid-sharded engine (`core.distributed_xl`) takes all three with
    collectives over the model dim.

    Returns (settled, lb_dec, d_a, n_need).
    """
    C = state.stats.C
    b = x.shape[0]
    seen = a_prev >= 0
    if p_max is None:
        p_max = torch.max(state.stats.p)
    lb_dec = state.points.lb[:b] - p_max
    d_a = (_dist_to_assigned(x, C, a_prev) if d_assigned is None
           else d_assigned)
    thresh = lb_dec
    if use_shalf:
        if s_half is None:
            s_half = _half_intercentroid(C)
        thresh = torch.maximum(lb_dec, s_half[a_prev.clamp_min(0).long()])
    settled = seen & (d_a <= thresh)
    if valid is not None:
        # masked pads never need recompute; the caller forces their
        # outputs back to the never-assigned sentinel
        settled = settled | ~valid
    n_need = (~settled).sum(dtype=torch.int32)
    return settled, lb_dec, d_a, n_need


def _fused_dense_round(x, state, a_prev, valid, *, bounds: str,
                       use_shalf: bool, plan: KernelPlan):
    """Route the dense assignment through `ops.fused_nested_round`: one
    call replaces assign / delta-S/v / sse. Returns the `_assign_*`
    6-tuple with the fused (dS, dv, sse) in the last slot."""
    b = x.shape[0]
    if bounds == "hamerly2":
        settled, lb_dec, d_a, n_rec = _hamerly_settled(
            x, state, a_prev, valid, use_shalf=use_shalf)
    else:                               # bounds == "none"
        settled = torch.zeros((b,), dtype=torch.bool, device=x.device)
        lb_dec = torch.zeros((b,), dtype=torch.float32, device=x.device)
        d_a = torch.zeros((b,), dtype=torch.float32, device=x.device)
        n_rec = (_scalar(b, x) if valid is None
                 else valid.sum(dtype=torch.int32))
    vmask = (torch.ones((b,), dtype=torch.bool, device=x.device)
             if valid is None else valid)
    a_new, d_new, lb_new, dS, dv, sse = ops.fused_nested_round(
        x, state.stats.C, a_prev, settled, d_a, lb_dec, vmask, plan=plan)
    return (a_new, d_new, lb_new, n_rec, _scalar(False, x, torch.bool),
            (dS, dv, sse))


def _assign_hamerly2(x, state, a_prev, valid, *, capacity: Optional[int],
                     use_shalf: bool, plan=None, p_max=None,
                     d_assigned=None, s_half=None, assign_top2_fn=None):
    """Exact-refresh upper bound + decayed 2nd-nearest lower bound.

      1. lb' = lb - max_j p(j)                       (bound decay, eq. 4)
      2. d_a = ||x - C(a)|| exact for every point
      3. settled iff d_a <= max(lb', s_half(a))      (Hamerly tests)
      4. the unsettled are COMPACTED into a ``capacity``-sized buffer
         and only that buffer goes through the top-2 kernel.
    If more than ``capacity`` points need recompute the round reports
    overflow=True and the loop retries the same input state with a
    larger bucket. ``capacity=None`` recomputes everything.

    The ``p_max``, ``d_assigned``, ``s_half`` and ``assign_top2_fn``
    overrides are for the centroid-sharded engine
    (`core.distributed_xl`), which takes these four with collectives
    over the model dim; the bound and compaction schedule lives only
    here, so the engines cannot drift apart.
    """
    C = state.stats.C
    b = x.shape[0]
    if assign_top2_fn is None:
        def assign_top2_fn(xs):
            return ops.assign_top2(xs, C, plan=plan)
    settled, lb_dec, d_a, n_need = _hamerly_settled(
        x, state, a_prev, valid, use_shalf=use_shalf, p_max=p_max,
        d_assigned=d_assigned, s_half=s_half)
    needs = ~settled

    if capacity is None or capacity >= b:
        a_full, d1sq, d2sq = assign_top2_fn(x)
        a_new = torch.where(settled, a_prev, a_full)
        d_new = torch.where(settled, d_a, _euclid(d1sq))
        lb_new = torch.where(settled, lb_dec, _euclid(d2sq))
        return (a_new, d_new, lb_new, n_need, _scalar(False, x, torch.bool),
                None)

    # compact-and-batch: unsettled points first (the stable sort keeps
    # their order)
    order = torch.argsort((~needs).to(torch.int32), stable=True)
    idx_cap = order[:capacity]
    a_cap, d1sq, d2sq = assign_top2_fn(x[idx_cap])

    # settled points carry the decayed bound + exact distance; the
    # recomputed buffer is scattered back (exact for every entry,
    # including settled points that padded the buffer)
    a_new = a_prev.clone()
    d_new = torch.where(settled, d_a, state.points.d[:b])
    lb_new = torch.where(settled, lb_dec, state.points.lb[:b])
    a_new[idx_cap] = a_cap
    d_new[idx_cap] = _euclid(d1sq)
    lb_new[idx_cap] = _euclid(d2sq)
    overflow = n_need > capacity
    return (a_new, d_new, lb_new, torch.clamp_max(n_need, capacity),
            overflow, None)


def _assign_elkan(x, state, a_prev, valid):
    """Elkan's bounds: one lower bound l(i, j) per (point, centroid).

    All the distances the bound tests let through are computed at once
    instead of one by one; the assignment is the same, and
    ``n_recomputed`` counts the pair distances a serial implementation
    would compute (every pair that fails its test, plus each seen
    point's distance to its own centroid). Pad rows (``valid`` false)
    compute nothing; the caller resets their outputs. There is no
    second-nearest bound: the 3rd slot is None and ``lb`` stays.
    """
    C = state.stats.C
    k = C.shape[0]
    b = x.shape[0]
    seen = a_prev >= 0
    l_dec = state.elkan.l[:b] - state.stats.p[None, :]
    d_a = _dist_to_assigned(x, C, a_prev)

    d_all = _euclid(ref.pairwise_dist2(x, C))                  # (b, k)
    own = torch.arange(k, device=x.device)[None, :] == a_prev[:, None]
    compute = (l_dec < d_a[:, None]) & ~own                    # bound test
    compute = compute | ~seen[:, None]                         # new: all k
    if valid is not None:
        compute = compute & valid[:, None]

    l_new = torch.where(compute, d_all, l_dec)
    cand = torch.where(compute, d_all, INF)
    cand = torch.where(own & seen[:, None], d_a[:, None], cand)
    a_new = torch.argmin(cand, dim=1).to(torch.int32)
    d_new = torch.min(cand, dim=1).values
    # + the d_a's (pads are never seen, so they add nothing here)
    n_comp = compute.sum(dtype=torch.int32) + seen.sum(dtype=torch.int32)
    return (a_new, d_new, None, n_comp, _scalar(False, x, torch.bool),
            l_new)


def _assign_exponion(x, state, a_prev, valid, *, use_shalf: bool):
    """Annular candidate pruning (Newling and Fleuret's exponion).

    The Hamerly test of `_hamerly_settled`, with s/2 read off the
    geometry table; a point that fails it scans only the centroids
    within R = 2 d(x, c_a) + s(a) of its anchor c_a. Every centroid tied
    at the minimum lies within 2 d(x, c_a) <= R, and so does the anchor's
    nearest neighbour, so the candidates' argmin (lowest index first) and
    second minimum are an exhaustive scan's. Centroids at exactly R are
    in (a ``<=`` ring count). The top-2 is taken in squared space, as
    `ops.assign_top2` takes it.

    ``n_recomputed`` counts pair distances (the elkan convention): every
    scanned (point, centroid) pair plus each seen point's d_a.
    """
    C = state.stats.C
    k = C.shape[0]
    geom = build_exponion_geom(C)
    seen = a_prev >= 0
    settled, lb_dec, d_a, _ = _hamerly_settled(
        x, state, a_prev, valid, use_shalf=use_shalf, s_half=0.5 * geom.s)
    needs = ~settled

    anchor = a_prev.clamp(0, k - 1).long()
    R = 2.0 * d_a + geom.s[anchor]
    rows = geom.dist[anchor]                                   # (b, k)
    m_exact = (rows <= R[:, None]).sum(dim=1, dtype=torch.int32)
    ring = geom.rank[anchor] < m_exact[:, None]
    scan = needs[:, None] & (ring | ~seen[:, None])            # new: all k
    if valid is not None:
        scan = scan & valid[:, None]

    cand = torch.where(scan, ref.pairwise_dist2(x, C), INF)
    a_f = torch.argmin(cand, dim=1)
    d1sq = torch.gather(cand, 1, a_f[:, None])[:, 0]
    rest = torch.where(torch.arange(k, device=x.device)[None, :]
                       == a_f[:, None], INF, cand)
    d1, d2 = _euclid(d1sq), _euclid(torch.min(rest, dim=1).values)

    a_new = torch.where(settled, a_prev, a_f.to(torch.int32))
    d_new = torch.where(settled, d_a, d1)
    lb_new = torch.where(settled, lb_dec, d2)
    # pads are never seen, so they add nothing
    n_comp = scan.sum(dtype=torch.int32) + seen.sum(dtype=torch.int32)
    return (a_new, d_new, lb_new, n_comp, _scalar(False, x, torch.bool),
            None)


def nested_round(X: torch.Tensor, state: KMeansState, *, b: int,
                 rho: float, bounds: str = "hamerly2",
                 capacity: Optional[int] = None, use_shalf: bool = True,
                 plan: Optional[KernelPlan] = None,
                 n_valid: Optional[int] = None,
                 mesh=None, data_axes: Tuple[str, ...] = ()
                 ) -> Tuple[KMeansState, RoundInfo]:
    """One gb/tb round over the nested prefix ``X[:b]``.

    Previously-seen points are reassigned with delta S/v corrections,
    unseen points (``a == -1``) enter the batch, the centroids move to
    S/v, and the controller votes on doubling b.

    ``n_valid``: rows at positions >= n_valid are structural pads: held
    out of the assignment (``a == -1``), contributing nothing to
    S/v/sse/mse, and excluded from n_active/n_changed.

    ``mesh`` and ``data_axes``: when each rank holds a slice of the
    points, sharded over these named dims of a `DeviceMesh` (b is the
    LOCAL prefix; the global batch is the union of the ranks' prefixes),
    the S/v/sse deltas and the RoundInfo sums are all-reduced over them
    before the stats update, so the replicated stats, and with them the
    growth decision, are the same bits on every rank.

    ``plan``: the fit's `KernelPlan`. A "cuda" plan routes the dense
    shapes (gb, or tb with capacity covering the batch) through the fused
    kernel.
    """
    # trace accounting: the statics that would key one compiled
    # executable (or one CUDA graph) of this round, the operands' width,
    # type and device among them; the first call of each key counts as
    # its trace (`repro_torch.analysis.retrace` checks that a fit keys
    # each of its pow2 buckets exactly once)
    k = state.stats.C.shape[0]
    tracecount.record("nested_round", b=b, capacity=capacity, rho=rho,
                      bounds=bounds, plan=plan, k=k, d=X.shape[-1],
                      dtype=X.dtype, device=X.device)
    x = X[:b]
    a_prev = state.points.a[:b]
    valid = (None if n_valid is None
             else torch.arange(b, device=X.device) < n_valid)

    fused = (plan is not None and plan.backend == "cuda"
             and (bounds == "none"
                  or (bounds == "hamerly2"
                      and (capacity is None or capacity >= b))))
    fused_acc = l_new = None
    if fused:
        a_new, d_new, lb2, n_rec, overflow, fused_acc = _fused_dense_round(
            x, state, a_prev, valid, bounds=bounds, use_shalf=use_shalf,
            plan=plan)
    elif bounds == "none":
        a_new, d_new, lb2, n_rec, overflow, _ = _assign_exhaustive(
            x, state, valid, plan=plan)
    elif bounds == "hamerly2":
        a_new, d_new, lb2, n_rec, overflow, _ = _assign_hamerly2(
            x, state, a_prev, valid, capacity=capacity,
            use_shalf=use_shalf, plan=plan)
    elif bounds == "elkan":
        a_new, d_new, lb2, n_rec, overflow, l_new = _assign_elkan(
            x, state, a_prev, valid)
    elif bounds == "exponion":
        a_new, d_new, lb2, n_rec, overflow, _ = _assign_exponion(
            x, state, a_prev, valid, use_shalf=use_shalf)
    else:
        raise ValueError(f"unknown bounds {bounds!r}")

    if valid is not None:
        # idempotent on the fused path (the kernel already masked)
        a_new = torch.where(valid, a_new, torch.full_like(a_new, -1))
        d_new = torch.where(valid, d_new, torch.zeros_like(d_new))
        if lb2 is not None:
            lb2 = torch.where(valid, lb2, torch.zeros_like(lb2))
        if l_new is not None:
            # pads keep a zero bound (their lanes are dead)
            l_new = torch.where(valid[:, None], l_new,
                                torch.zeros_like(l_new))

    if fused_acc is not None:
        dS, dv, sse = fused_acc
    else:
        dS, dv = _delta_sv(x, a_prev, a_new, k, plan)
        sse = _refresh_sse(d_new, a_new, k, plan)
    mse_num = torch.sum(d_new * d_new)
    n_changed = ((a_prev >= 0) & (a_new != a_prev)).sum(dtype=torch.int32)
    n_active = (_scalar(b, x) if valid is None
                else valid.sum(dtype=torch.int32))
    # the batch MSE's denominator is n_active: a count, reduced with the
    # integers, where f32 would be exact only to 2^24 rows
    dS, dv, sse, mse_num, n_changed, n_active, n_rec, overflow = \
        collectives.psum((dS, dv, sse, mse_num, n_changed, n_active, n_rec,
                          overflow), mesh, data_axes)

    stats = dataclasses.replace(state.stats, S=state.stats.S + dS,
                                v=state.stats.v + dv, sse=sse)
    stats = centroid_update(stats)
    grow, r_med = controller.should_grow(stats.sse, stats.v, stats.p, rho)

    a_all = state.points.a.clone()
    d_all = state.points.d.clone()
    a_all[:b] = a_new
    d_all[:b] = d_new
    points = dataclasses.replace(state.points, a=a_all, d=d_all)
    if lb2 is not None:
        lb_all = state.points.lb.clone()
        lb_all[:b] = lb2
        points = dataclasses.replace(points, lb=lb_all)
    elkan = state.elkan
    if l_new is not None:
        l_all = state.elkan.l.clone()
        l_all[:b] = l_new
        elkan = ElkanBounds(l=l_all)

    info = RoundInfo(
        batch_mse=mse_num / torch.clamp_min(n_active.float(), 1.0),
        n_changed=n_changed, n_recomputed=n_rec.to(torch.int32),
        n_active=n_active, overflow=overflow.to(torch.bool), grow=grow,
        r_median=r_med, p_max=torch.max(stats.p))
    new_state = dataclasses.replace(state, stats=stats, points=points,
                                    elkan=elkan, round=state.round + 1)
    return new_state, info

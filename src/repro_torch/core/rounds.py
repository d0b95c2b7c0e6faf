"""One nested round (gb-rho / tb-rho) over the prefix ``X[:b]``.

Port of `repro/core/rounds.py::nested_round` for the bound families
``"none"`` (gb: every active point scans all k) and ``"hamerly2"`` (tb:
two bounds per point plus capacity compaction). Both are exact: the bound
tests only skip work that provably cannot change an assignment.

The bound DECISIONS stay here in plain torch (`_hamerly_settled`), exactly
as the JAX package keeps them out of its kernels, so the growth and
compaction schedule cannot drift between the plain and the kernel path.
Per-cluster float sums go through `ops.cluster_sum`, whose kernel is
deterministic (a CUDA `index_add_` adds with atomics in no fixed order).

elkan, exponion, lloyd, mb and mbf are ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import collectives, controller
from repro_torch.core.state import KMeansState, RoundInfo, centroid_update
from repro_torch.kernels import ops, ref
from repro_torch.kernels.plan import KernelPlan

PORTED_BOUNDS = ("none", "hamerly2")


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 item 5)")


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


# --------------------------------------------------------------------------
# nested rounds
# --------------------------------------------------------------------------

def _assign_exhaustive(x, state, valid, *, plan):
    """bounds='none': full top-2 for every active point."""
    a_new, d1sq, d2sq = ops.assign_top2(x, state.stats.C, plan=plan)
    n_rec = (_scalar(x.shape[0], x) if valid is None
             else valid.sum(dtype=torch.int32))
    return (a_new, _euclid(d1sq), _euclid(d2sq), n_rec,
            _scalar(False, x, torch.bool), None)


def _hamerly_settled(x, state, a_prev, valid, *, use_shalf: bool):
    """The Hamerly bound DECISIONS for one round's active slice.

    Whatever executes the assignment, the settled mask (and so the bound
    and compaction schedule) comes from this one function.

    Returns (settled, lb_dec, d_a, n_need).
    """
    C = state.stats.C
    b = x.shape[0]
    seen = a_prev >= 0
    lb_dec = state.points.lb[:b] - torch.max(state.stats.p)
    d_a = _dist_to_assigned(x, C, a_prev)
    thresh = lb_dec
    if use_shalf:
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
                     use_shalf: bool, plan=None):
    """Exact-refresh upper bound + decayed 2nd-nearest lower bound.

      1. lb' = lb - max_j p(j)                       (bound decay, eq. 4)
      2. d_a = ||x - C(a)|| exact for every point
      3. settled iff d_a <= max(lb', s_half(a))      (Hamerly tests)
      4. the unsettled are COMPACTED into a ``capacity``-sized buffer
         and only that buffer goes through the top-2 kernel.
    If more than ``capacity`` points need recompute the round reports
    overflow=True and the loop retries the same input state with a
    larger bucket. ``capacity=None`` recomputes everything.
    """
    C = state.stats.C
    b = x.shape[0]
    settled, lb_dec, d_a, n_need = _hamerly_settled(
        x, state, a_prev, valid, use_shalf=use_shalf)
    needs = ~settled

    if capacity is None or capacity >= b:
        a_full, d1sq, d2sq = ops.assign_top2(x, C, plan=plan)
        a_new = torch.where(settled, a_prev, a_full)
        d_new = torch.where(settled, d_a, _euclid(d1sq))
        lb_new = torch.where(settled, lb_dec, _euclid(d2sq))
        return (a_new, d_new, lb_new, n_need, _scalar(False, x, torch.bool),
                None)

    # compact-and-batch: unsettled points first (the stable sort keeps
    # their order)
    order = torch.argsort((~needs).to(torch.int32), stable=True)
    idx_cap = order[:capacity]
    a_cap, d1sq, d2sq = ops.assign_top2(x[idx_cap], C, plan=plan)

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
    if bounds not in PORTED_BOUNDS:
        if bounds in ("elkan", "exponion"):
            raise not_ported(f"bounds={bounds!r}")
        raise ValueError(f"unknown bounds {bounds!r}")
    k = state.stats.C.shape[0]
    x = X[:b]
    a_prev = state.points.a[:b]
    valid = (None if n_valid is None
             else torch.arange(b, device=X.device) < n_valid)

    fused = (plan is not None and plan.backend == "cuda"
             and (bounds == "none"
                  or (bounds == "hamerly2"
                      and (capacity is None or capacity >= b))))
    fused_acc = None
    if fused:
        a_new, d_new, lb2, n_rec, overflow, fused_acc = _fused_dense_round(
            x, state, a_prev, valid, bounds=bounds, use_shalf=use_shalf,
            plan=plan)
    elif bounds == "none":
        a_new, d_new, lb2, n_rec, overflow, _ = _assign_exhaustive(
            x, state, valid, plan=plan)
    else:
        a_new, d_new, lb2, n_rec, overflow, _ = _assign_hamerly2(
            x, state, a_prev, valid, capacity=capacity,
            use_shalf=use_shalf, plan=plan)

    if valid is not None:
        # idempotent on the fused path (the kernel already masked)
        a_new = torch.where(valid, a_new, torch.full_like(a_new, -1))
        d_new = torch.where(valid, d_new, torch.zeros_like(d_new))
        lb2 = torch.where(valid, lb2, torch.zeros_like(lb2))

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
    lb_all = state.points.lb.clone()
    a_all[:b] = a_new
    d_all[:b] = d_new
    lb_all[:b] = lb2
    points = dataclasses.replace(state.points, a=a_all, d=d_all, lb=lb_all)

    info = RoundInfo(
        batch_mse=mse_num / torch.clamp_min(n_active.float(), 1.0),
        n_changed=n_changed, n_recomputed=n_rec.to(torch.int32),
        n_active=n_active, overflow=overflow.to(torch.bool), grow=grow,
        r_median=r_med, p_max=torch.max(stats.p))
    new_state = dataclasses.replace(state, stats=stats, points=points,
                                    round=state.round + 1)
    return new_state, info

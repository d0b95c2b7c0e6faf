"""Centroid-sharded nested rounds on torch.distributed (the kmeans_xl
engine's core).

Port of `repro/core/distributed_xl.py`. `rounds.nested_round` with the
cluster stats sharded over a model dim, which `repro_torch.api.engines.xl`
drives through the shared host loop: per-shard prefix batching with
``n_valid`` masking, previously-seen-point delta S/v, the bound families,
growth, overflow retry and checkpoints, at centroid counts too large to
replicate. As in the port's mesh engine, one rank per process: each rank
runs the round body on what it holds, and the psums, reduce-scatters and
ring permutes over JAX's named axes are collectives over the process
groups of a `DeviceMesh`'s named dims (`core/collectives.py`).

Layout:
  * points row-sharded over ``data_axes`` as in the mesh engine (the
    `data.pipeline.nested_shard_layout` placement), and REPLICATED over
    ``model_axis``.
  * cluster stats sharded over ``model_axis``: model rank i holds the
    (k_local, d) slice of C/S and the (k_local,) slices of v/sse/p of
    global rows [i k_local, (i + 1) k_local), replicated over the data
    dims; the elkan bounds ``l`` hold this rank's (rows, k_local) block.
  * assignment: each model rank scans its k-slice with the top-2 kernel
    and the per-rank (d1, d2, index) triples are all-gathered over
    ``model_axis`` and tree-folded (`distributed.assign_top2_sharded`),
    so ``a`` holds GLOBAL centroid indices, the same on every model rank.
  * delta S/v: the batch rows are dealt into ``m`` chunks, one per model
    rank; each rank sums full-k partials over ITS chunk only (an m-fold
    cut of the work), and one reduce-scatter over ``model_axis`` both
    reduces the chunks and hands each rank exactly its k-slice. sse
    follows the same way. The sum over the data dims is one all-reduce of
    the deltas with the round's scalars, packed as `rounds.nested_round`
    packs them.
  * growth: the (k_local,) v/sse/p are all-gathered over ``model_axis``
    and fed to `controller.should_grow` with the config's rho.

Bit-compatibility: on a one-rank model dim every model collective gives
its input back and each step is `rounds.nested_round`'s, operation for
operation, so an XL fit with one model rank reproduces the mesh fit (and,
with one data rank, the local fit) bit for bit.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import collectives, controller, rounds
from repro_torch.core.distributed import (_fold_top2, _tree_fold,
                                          assign_top2_sharded,
                                          per_shard_n_valid, shard_state)
from repro_torch.core.rounds import INF, _euclid, _scalar
from repro_torch.core.state import (ClusterStats, ElkanBounds, KMeansState,
                                    RoundInfo, centroid_update)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.plan import KernelPlan
from repro_torch.util import tracecount


# --------------------------------------------------------------------------
# sharded building blocks
# --------------------------------------------------------------------------

def _dist_to_assigned_sharded(x: torch.Tensor, C_local: torch.Tensor,
                              a: torch.Tensor, k_offset: int, mesh,
                              model_axis: str) -> torch.Tensor:
    """Exact euclidean distance of each point to its assigned centroid.

    The assigned centroid may live on any model rank: each rank takes
    the distance for the points whose GLOBAL assignment falls in its
    k-slice and 0 for the rest, and one psum over ``model_axis``
    assembles the vector (one nonzero term a row, so it is exact).
    Never-assigned points (``a == -1``) fall outside every slice and
    come back 0; ``seen`` gates every use of them downstream.
    """
    k_local = C_local.shape[0]
    a_loc = a - k_offset
    own = (a_loc >= 0) & (a_loc < k_local)
    Cg = C_local[a_loc.clamp(0, k_local - 1).long()]
    d2 = torch.sum((x.float() - Cg) ** 2, dim=1)
    (d2,) = collectives.psum((torch.where(own, d2, 0.0),), mesh,
                             (model_axis,))
    return _euclid(d2)


def _half_intercentroid_sharded(C_local: torch.Tensor, mesh,
                                model_axis: str) -> torch.Tensor:
    """Hamerly's s(j)/2 for every GLOBAL j, from the ranks' k-slices.

    A ring: the (k_local, d) centroid blocks travel around the model dim,
    and at each of the m - 1 steps every rank folds the visiting block's
    distances into its running minimum a centroid. Peak memory stays
    O(k_local d): no rank builds the full (k, d) codebook, the engine's
    reason to exist. (min is exact, so the fold equals a row min of the
    dense matrix.) The (k_local,) results are all-gathered into the
    (k,) table every rank's bound test reads.
    """
    d2_own = ref.pairwise_dist2(C_local, C_local)
    d2_own.fill_diagonal_(INF)          # the self-distance, by position
    best = torch.min(d2_own, dim=1).values
    block = C_local
    for _ in range(collectives.axis_size(mesh, model_axis) - 1):
        block = collectives.ppermute_ring(block, mesh, model_axis)
        best = torch.minimum(
            best, torch.min(ref.pairwise_dist2(C_local, block),
                            dim=1).values)
    s_half = 0.5 * _euclid(best)
    return collectives.all_gather(s_half, mesh, model_axis).reshape(-1)


def _fold_min_idx(da, ia, db, ib):
    """Combine two (min, argmin) pairs; a tie takes the LOWER global
    index, which makes the fold associative and commutative and matches
    `torch.argmin`'s first minimum on the unsharded row."""
    take_b = (db < da) | ((db == da) & (ib < ia))
    return torch.minimum(da, db), torch.where(take_b, ib, ia)


def _assign_elkan_xl(x, state, a_prev, valid, *, k_offset: int, mesh,
                     model_axis: str):
    """`rounds._assign_elkan` with the k column sharded over the model
    dim: each rank holds the (b, k_local) block of the lower-bound
    matrix l and its slices of C and p, runs the bound test on them, and
    the ranks' (min, argmin) candidates are tree-folded into the global
    assignment. Bit-equal to the local path on one model rank."""
    C_local = state.stats.C
    k_local = C_local.shape[0]
    seen = a_prev >= 0
    l_dec = state.elkan.l[:x.shape[0]] - state.stats.p[None, :]
    d_a = _dist_to_assigned_sharded(x, C_local, a_prev, k_offset, mesh,
                                    model_axis)

    d_all = _euclid(ref.pairwise_dist2(x, C_local))         # (b, k_local)
    cols = k_offset + torch.arange(k_local, device=x.device)[None, :]
    own = cols == a_prev[:, None]                            # GLOBAL
    compute = (l_dec < d_a[:, None]) & ~own                  # bound test
    compute = compute | ~seen[:, None]                       # new: all k
    if valid is not None:
        compute = compute & valid[:, None]

    l_new = torch.where(compute, d_all, l_dec)
    cand = torch.where(compute, d_all, INF)
    cand = torch.where(own & seen[:, None], d_a[:, None], cand)
    # the local winner carries its GLOBAL index; fold across the ranks
    a_loc = torch.argmin(cand, dim=1).to(torch.int32) + k_offset
    d_loc = torch.min(cand, dim=1).values
    d_new, a_new = _tree_fold(
        _fold_min_idx, collectives.all_gather(d_loc, mesh, model_axis),
        collectives.all_gather(a_loc, mesh, model_axis))
    # the pairs computed over the whole k row + the d_a's (pads are
    # never seen, so they add nothing)
    (n_comp,) = collectives.psum((compute.sum(dtype=torch.int32),), mesh,
                                 (model_axis,))
    n_comp = n_comp + seen.sum(dtype=torch.int32)
    return (a_new.to(torch.int32), d_new, None, n_comp,
            _scalar(False, x, torch.bool), l_new)


def _exponion_geom_xl(C_local: torch.Tensor, mesh, model_axis: str,
                      k_offset: int):
    """The exponion geometry from the ranks' k-slices: (B, s).

    ``B`` is this rank's (k, k_local) block of the inter-centroid
    distances (rows the GLOBAL anchors, columns the local centroids),
    assembled by the same ring as `_half_intercentroid_sharded`, so a
    rank holds O(k^2 / m) of it, never the k x k table. ``s`` is the
    full (k,) nearest-other-centroid table (min over the local columns,
    then pmin over the model dim): it feeds both the Hamerly threshold
    (s/2) and the annulus radius (2 d_a + s), as the local geometry does.

    B's own diagonal is set to an EXACT 0: the anchor must always pass
    its own ``<= R`` test (the product form can leave rounding dust
    there), which makes the union of the ranks' candidate sets the exact
    global annulus.
    """
    k_local = C_local.shape[0]
    m = collectives.axis_size(mesh, model_axis)
    ax = collectives.axis_index(mesh, model_axis)
    cols = torch.arange(k_local, device=C_local.device)
    own_rows = k_offset + cols

    B = torch.zeros((k_local * m, k_local), dtype=torch.float32,
                    device=C_local.device)
    block = C_local
    for step in range(m):
        # after `step` rotations this rank holds the block that started
        # on rank (ax - step) % m: those are its rows of B
        src = (ax - step) % m
        B[src * k_local:(src + 1) * k_local] = _euclid(
            ref.pairwise_dist2(block, C_local))
        if step < m - 1:
            block = collectives.ppermute_ring(block, mesh, model_axis)

    B[own_rows, cols] = 0.0
    masked = B.clone()
    masked[own_rows, cols] = INF
    s = collectives.pmin(torch.min(masked, dim=1).values, mesh, model_axis)
    return B, s


def _assign_exponion_xl(x, state, a_prev, valid, *, k_offset: int, mesh,
                        model_axis: str, use_shalf: bool):
    """`rounds._assign_exponion` with the centroids model-sharded.

    Each rank tests its local centroid columns against the EXACT annulus
    (``B[anchor] <= R``); with no sorted neighbour table across ranks, it
    counts its block's members directly. The union of the ranks'
    candidate sets is the exact annulus plus full rows for unseen points,
    the set the local path's ``rank < m_exact`` mask selects, so labels,
    centroids, the stored lb AND the ``n_recomputed`` pair count are the
    local exponion's (and labels and centroids ``bounds="none"``'s).

    Degenerate rings: where k / m leaves fewer than 4 local columns, an
    annulus test cannot beat scanning the row it would test, so failing
    points scan their whole local slice and B is not built (the s table
    still comes from the ring, for the Hamerly threshold).

    The ranks' (min, 2nd-min, global argmin) triples are tree-folded
    with `distributed._fold_top2` (the lower global index wins a tie),
    so the fold matches an argmin over the unsharded row.
    """
    C_local = state.stats.C
    k_local = C_local.shape[0]
    k = k_local * collectives.axis_size(mesh, model_axis)
    b = x.shape[0]
    seen = a_prev >= 0
    degenerate = k_local < 4

    p_max = collectives.pmax(torch.max(state.stats.p), mesh, model_axis)
    d_a = _dist_to_assigned_sharded(x, C_local, a_prev, k_offset, mesh,
                                    model_axis)
    if degenerate:
        s_half = _half_intercentroid_sharded(C_local, mesh, model_axis)
    else:
        B, s = _exponion_geom_xl(C_local, mesh, model_axis, k_offset)
        s_half = 0.5 * s
    settled, lb_dec, d_a, _ = rounds._hamerly_settled(
        x, state, a_prev, valid, use_shalf=use_shalf, p_max=p_max,
        d_assigned=d_a, s_half=s_half)
    needs = ~settled

    if degenerate:
        scan = needs[:, None].expand(b, k_local)
    else:
        anchor = a_prev.clamp(0, k - 1).long()
        R = 2.0 * d_a + s[anchor]
        scan = needs[:, None] & ((B[anchor] <= R[:, None])
                                 | ~seen[:, None])
    if valid is not None:
        scan = scan & valid[:, None]

    # the candidates' top-2 in SQUARED space (the units
    # `assign_top2_sharded` folds in), the square roots after the fold
    cand = torch.where(scan, ref.pairwise_dist2(x, C_local), INF)
    a_col = torch.argmin(cand, dim=1)
    d1_loc = torch.min(cand, dim=1).values
    rest = torch.where(torch.arange(k_local, device=x.device)[None, :]
                       == a_col[:, None], INF, cand)
    d2_loc = torch.min(rest, dim=1).values
    d1, d2, a_f = _tree_fold(
        _fold_top2, collectives.all_gather(d1_loc, mesh, model_axis),
        collectives.all_gather(d2_loc, mesh, model_axis),
        collectives.all_gather(a_col.to(torch.int32) + k_offset, mesh,
                               model_axis))

    a_new = torch.where(settled, a_prev, a_f.to(torch.int32))
    d_new = torch.where(settled, d_a, _euclid(d1))
    lb_new = torch.where(settled, lb_dec, _euclid(d2))
    # the pairs (elkan's convention): the scanned pairs + the d_a of each
    # seen point (pads are never seen, so they add nothing)
    (n_comp,) = collectives.psum((scan.sum(dtype=torch.int32),), mesh,
                                 (model_axis,))
    n_comp = n_comp + seen.sum(dtype=torch.int32)
    return (a_new, d_new, lb_new, n_comp, _scalar(False, x, torch.bool),
            None)


def _chunk_rows(arrs: Sequence[torch.Tensor], *, mesh,
                model_axis: str) -> list:
    """Deal the batch rows into ``m`` chunks, one per model rank.

    The rows are padded with zeros up to a multiple of ``m`` (the pads'
    weights are 0, so they add nothing) and model rank i takes chunk i:
    this is what makes the reduce-scatter below an m-fold cut of the
    sums' work too. Only the last chunks hold pads; the others are views.
    """
    m = collectives.axis_size(mesh, model_axis)
    b = arrs[0].shape[0]
    chunk = -(-b // m)
    lo = min(collectives.axis_index(mesh, model_axis) * chunk, b)
    hi = min(lo + chunk, b)
    out = []
    for a in arrs:
        part = a[lo:hi]
        if hi - lo < chunk:
            part = torch.cat([part, part.new_zeros(
                (chunk - (hi - lo),) + tuple(a.shape[1:]))])
        out.append(part)
    return out


def _delta_sv_xl(x, a_prev, a_new, k: int, *, mesh, model_axis: str,
                 plan: Optional[KernelPlan]):
    """The nested S/v delta, reduced straight onto the k-slices.

    The weights are `rounds._delta_sv`'s (remove the expired, add the
    current; rows with ``a_new == -1`` add nothing). Each model rank sums
    full-k partials over its row chunk, and one reduce-scatter over
    ``model_axis`` of [dS | dv] reduces the m chunks AND hands each rank
    its own (k_local, d + 1) slice. This rank's share of the data dims'
    sum: the round all-reduces it over them with its scalars (JAX takes
    that psum here).
    """
    seen = a_prev >= 0
    changed = seen & (a_new != a_prev)
    w_rm = changed.float()
    w_add = ((changed | ~seen) & (a_new >= 0)).float()
    x_c, ap_c, an_c, w_rm_c, w_add_c = _chunk_rows(
        [x, a_prev.clamp(0, k - 1), a_new.clamp(0, k - 1), w_rm, w_add],
        mesh=mesh, model_axis=model_axis)
    S_rm, v_rm = ops.cluster_sum(x_c, ap_c, k, weights=w_rm_c, plan=plan)
    S_add, v_add = ops.cluster_sum(x_c, an_c, k, weights=w_add_c,
                                   plan=plan)
    dSv = collectives.psum_scatter(
        torch.cat([S_add - S_rm, (v_add - v_rm)[:, None]], dim=1), mesh,
        model_axis)
    return dSv[:, :-1], dSv[:, -1]


def _refresh_sse_xl(d_act, a_act, k: int, *, mesh, model_axis: str,
                    plan: Optional[KernelPlan]) -> torch.Tensor:
    """sse(j) over the active members of this rank's k-slice (exact),
    before the data dims' sum (see `_delta_sv_xl`)."""
    d_c, a_c = _chunk_rows([d_act, a_act.clamp(0, k - 1)], mesh=mesh,
                           model_axis=model_axis)
    return collectives.psum_scatter(
        rounds.segment_sum(d_c * d_c, a_c, k, plan), mesh, model_axis)


# --------------------------------------------------------------------------
# the nested XL round
# --------------------------------------------------------------------------

def xl_nested_round(X: torch.Tensor, state: KMeansState, *, b: int,
                    rho: float, bounds: str, mesh,
                    data_axes: Tuple[str, ...], model_axis: str,
                    capacity: Optional[int] = None, use_shalf: bool = True,
                    plan: Optional[KernelPlan] = None,
                    n_valid: Optional[int] = None
                    ) -> Tuple[KMeansState, RoundInfo]:
    """One gb/tb round over this rank's prefix ``X[:b]``, k sharded.

    The centroid-sharded mirror of `rounds.nested_round`: ``state.stats``
    holds this model rank's k-slice and ``state.points`` this data rank's
    rows (with GLOBAL assignment indices); ``b`` is the per-data-rank
    prefix and ``n_valid`` caps it at the rank's real rows, as in the
    mesh engine. ``bounds``: "none" (gb: the sharded top-2 for every
    active point), "hamerly2" (tb: its s(j)/2 table from the ring, the
    same capacity compaction and overflow retry as the local round),
    "elkan" (the l matrix's k column sharded, `_assign_elkan_xl`) and
    "exponion" (the geometry from the ring, `_assign_exponion_xl`). The
    RoundInfo is the same on every rank.

    ``mesh=None`` is the one-device form: every collective is the
    identity.
    """
    # trace accounting: the statics of `rounds.nested_round`'s key under
    # JAX's site name (see repro_torch.util.tracecount)
    m = collectives.axis_size(mesh, model_axis)
    C_local = state.stats.C
    k_local = C_local.shape[0]
    k = k_local * m
    tracecount.record("xl_nested_round", b=b, capacity=capacity, rho=rho,
                      bounds=bounds, plan=plan, k=k, d=X.shape[-1],
                      dtype=X.dtype, device=X.device)
    k_offset = collectives.axis_index(mesh, model_axis) * k_local

    x = X[:b]
    a_prev = state.points.a[:b]
    valid = (None if n_valid is None
             else torch.arange(b, device=X.device) < n_valid)

    def assign_fn(xs):
        return assign_top2_sharded(xs, C_local, mesh=mesh,
                                   model_axis=model_axis, k_offset=k_offset,
                                   plan=plan)

    # a "cuda" plan takes the dense shapes through the fused kernel, but
    # only at m == 1, where every model collective gives its input back
    # and the local k-slice IS the codebook; at m > 1 the sharded per-op
    # kernels below run
    fused = (plan is not None and plan.backend == "cuda" and m == 1
             and (bounds == "none"
                  or (bounds == "hamerly2"
                      and (capacity is None or capacity >= b))))
    fused_acc = l_new = None

    # the bound and compaction schedule lives ONLY in rounds.py: this
    # engine injects the quantities that need model collectives, so the
    # local and sharded paths cannot drift apart
    if fused:
        a_new, d_new, lb2, n_rec, overflow, fused_acc = \
            rounds._fused_dense_round(x, state, a_prev, valid,
                                      bounds=bounds, use_shalf=use_shalf,
                                      plan=plan)
    elif bounds == "none":
        a_new, d_new, lb2, n_rec, overflow, _ = rounds._assign_exhaustive(
            x, state, valid, plan=plan, assign_top2_fn=assign_fn)
    elif bounds == "hamerly2":
        p_max = collectives.pmax(torch.max(state.stats.p), mesh, model_axis)
        d_a = _dist_to_assigned_sharded(x, C_local, a_prev, k_offset, mesh,
                                        model_axis)
        s_half = (_half_intercentroid_sharded(C_local, mesh, model_axis)
                  if use_shalf else None)
        a_new, d_new, lb2, n_rec, overflow, _ = rounds._assign_hamerly2(
            x, state, a_prev, valid, capacity=capacity,
            use_shalf=use_shalf, plan=plan, p_max=p_max, d_assigned=d_a,
            s_half=s_half, assign_top2_fn=assign_fn)
    elif bounds == "elkan":
        a_new, d_new, lb2, n_rec, overflow, l_new = _assign_elkan_xl(
            x, state, a_prev, valid, k_offset=k_offset, mesh=mesh,
            model_axis=model_axis)
    elif bounds == "exponion":
        a_new, d_new, lb2, n_rec, overflow, _ = _assign_exponion_xl(
            x, state, a_prev, valid, k_offset=k_offset, mesh=mesh,
            model_axis=model_axis, use_shalf=use_shalf)
    else:
        raise ValueError(f"unsupported bounds for the XL engine: "
                         f"{bounds!r} (use 'none', 'hamerly2', 'elkan' "
                         f"or 'exponion')")

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
        # m == 1: the fused sums are already this rank's whole k
        dS, dv, sse = fused_acc
    else:
        dS, dv = _delta_sv_xl(x, a_prev, a_new, k, mesh=mesh,
                              model_axis=model_axis, plan=plan)
        sse = _refresh_sse_xl(d_new, a_new, k, mesh=mesh,
                              model_axis=model_axis, plan=plan)
    mse_num = torch.sum(d_new * d_new)
    n_changed = ((a_prev >= 0) & (a_new != a_prev)).sum(dtype=torch.int32)
    n_active = (_scalar(b, x) if valid is None
                else valid.sum(dtype=torch.int32))
    # one all-reduce over the data dims, packed as `rounds.nested_round`
    # packs it, so that one model rank gives the mesh engine's bits
    dS, dv, sse, mse_num, n_changed, n_active, n_rec, overflow = \
        collectives.psum((dS, dv, sse, mse_num, n_changed, n_active, n_rec,
                          overflow), mesh, data_axes)

    stats = dataclasses.replace(state.stats, S=state.stats.S + dS,
                                v=state.stats.v + dv, sse=sse)
    stats = centroid_update(stats)           # per slice: C <- S/v, p
    # the growth vote on the GLOBAL per-cluster stats (small vectors)
    v_all, sse_all, p_all = collectives.all_gather(
        torch.stack([stats.v, stats.sse, stats.p]), mesh,
        model_axis).transpose(0, 1).reshape(3, k)
    grow, r_med = controller.should_grow(sse_all, v_all, p_all, rho)

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
        r_median=r_med,
        p_max=collectives.pmax(torch.max(stats.p), mesh, model_axis))
    new_state = dataclasses.replace(state, stats=stats, points=points,
                                    elkan=elkan, round=state.round + 1)
    return new_state, info


# --------------------------------------------------------------------------
# the round factory and placement
# --------------------------------------------------------------------------

def make_xl_nested_round(mesh, data_axes: Tuple[str, ...], *,
                         model_axis: str = "model", b_local: int,
                         rho: float, bounds: str = "hamerly2",
                         capacity: Optional[int] = None,
                         use_shalf: bool = True,
                         n_real: Optional[int] = None,
                         plan: Optional[KernelPlan] = None):
    """The XL round of one (b_local, capacity) bucket over this rank's
    rows and k-slice: ``fn(X_local, state) -> (state, info)``.

    The centroid-sharded counterpart of
    `distributed.make_sharded_round`: the same per-rank ``n_valid`` from
    ``n_real`` (over the data dims; the model ranks of a data rank hold
    the same rows), plus the model dim's stat sharding.
    """
    data_axes = tuple(data_axes)
    return functools.partial(
        xl_nested_round, b=b_local, rho=rho, bounds=bounds, mesh=mesh,
        data_axes=data_axes, model_axis=model_axis, capacity=capacity,
        use_shalf=use_shalf, plan=plan,
        n_valid=per_shard_n_valid(mesh, data_axes, n_real))


def shard_state_xl(state: KMeansState, mesh, data_axes: Tuple[str, ...],
                   model_axis: str) -> KMeansState:
    """This rank's share of a full state in the XL layout: its rows of
    the per-point leaves (`distributed.shard_state`) and its k-slice of
    the stats. As in JAX, the elkan bounds are not carried."""
    st = shard_state(state, mesh, data_axes)
    m = collectives.axis_size(mesh, model_axis)
    k = state.stats.C.shape[0]
    if k % m:
        raise ValueError(f"k={k} does not divide over {m} model ranks")
    k_local = k // m
    lo = collectives.axis_index(mesh, model_axis) * k_local
    stats = ClusterStats(*(getattr(state.stats, f.name)[lo:lo + k_local]
                           .clone()
                           for f in dataclasses.fields(ClusterStats)))
    return dataclasses.replace(st, stats=stats)

"""Roofline-aware efficiency: achieved work per round against the
bound of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit.

Port of `repro/obs/efficiency.py`. The unit of work depends on the bound
family, and ``RoundInfo.n_recomputed`` is counted in that family's unit:

  * ``unit="kscan"`` (bounds none / hamerly2): one point scanned
    against all ``k`` centroids;
  * ``unit="pair"`` (bounds elkan / exponion): one (point, centroid)
    pair distance, since these families prune within the row.

``kscans``, ``dist_evals`` and ``hbm_bytes`` are counted exactly as the
JAX package counts them:

  * HBM bytes: ``4 * d`` per scanning point (the f32 row streamed once)
    plus the ``k * d * 4`` centroid block once per round; in pair units
    one row per ``k`` pairs (exact for full-row scans, an overestimate
    for small annuli).

The operations are priced the way the port's kernels do the distance
work (and PERF.md prices kernels 1 and 3): an f32 top-2 runs x·c as
three TF32 tensor-core products (3xTF32), so a pair costs ``3 * 2 * d``
TF32 operations, at 495 TFLOP/s. So ``flops``, ``bound_s`` and
``bottleneck`` differ from the JAX package's (TPU v5e, ``3 * d`` f32
operations a pair) by design: the bound is the least time this card
could take for the round's work, the larger of its bytes over 3.35 TB/s
and its operations over the TF32 peak (`roofline.analysis`). The
utilization ``bound_s / dt_s`` read against a card set below 700 W
should name that card's power limit.

Plain Python: safe to import anywhere, including inside the audited
host loop.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.roofline.analysis import roofline_terms

#: TF32 operations per (point, centroid, dim): three products of a
#: 3xTF32 dot (hi·hi, hi·lo, lo·hi), a multiply and an add each
TF32_FLOPS_PER_DIST = 3 * 2.0

#: bytes per f32 element streamed from memory
F32_BYTES = 4

#: bound family -> the unit its ``n_recomputed`` counter is measured in
BOUNDS_WORK_UNIT = {
    "none": "kscan",
    "hamerly2": "kscan",
    "elkan": "pair",
    "exponion": "pair",
}


@dataclasses.dataclass(frozen=True)
class RoundWork:
    """Priced work of one round: counts, the bound, and utilization."""
    kscans: int            # full-k-scan equivalents (exact in kscan
                           # units; ceil(pairs / k) in pair units)
    dist_evals: int        # (point, centroid) pair distance evals
    flops: float           # TF32 operations of the 3xTF32 products
    hbm_bytes: float
    bound_s: float         # H100 roofline lower bound for this work
    bottleneck: str        # "compute" | "memory"
    dt_s: Optional[float] = None
    utilization: Optional[float] = None   # bound_s / dt_s, in [0, ~1]
    unit: str = "kscan"    # what n_recomputed counted ("kscan" | "pair")


class WorkModel:
    """Prices nested rounds for a fixed ``(k, d)`` problem shape.

    ``unit`` declares what the rounds' ``n_recomputed`` counts: "kscan"
    (none/hamerly2) or "pair" (elkan/exponion). `for_bounds` picks the
    unit from a fit's bound family.
    """

    def __init__(self, k: int, d: int, unit: str = "kscan"):
        if k < 1 or d < 1:
            raise ValueError(f"WorkModel needs k, d >= 1, got k={k} d={d}")
        if unit not in ("kscan", "pair"):
            raise ValueError(f"unknown work unit {unit!r}")
        self.k = int(k)
        self.d = int(d)
        self.unit = unit

    @classmethod
    def for_bounds(cls, k: int, d: int, bounds: str) -> "WorkModel":
        """The model whose unit matches a bound family's counter."""
        return cls(k, d, unit=BOUNDS_WORK_UNIT.get(bounds, "kscan"))

    def pair_evals(self, n_recomputed: int) -> int:
        """``n_recomputed`` converted to pair-distance evaluations."""
        n = max(0, int(n_recomputed))
        return n * self.k if self.unit == "kscan" else n

    def flops(self, n_recomputed: int) -> float:
        return TF32_FLOPS_PER_DIST * self.d * self.pair_evals(n_recomputed)

    def hbm_bytes(self, n_recomputed: int) -> float:
        n = max(0, int(n_recomputed))
        rows = n if self.unit == "kscan" else -(-n // self.k)
        return F32_BYTES * (rows * self.d + self.k * self.d)

    def round_work(self, n_recomputed: int,
                   dt_s: Optional[float] = None) -> RoundWork:
        """Price a round; with ``dt_s`` also compute utilization."""
        n = max(0, int(n_recomputed))
        rl = roofline_terms(0.0, self.hbm_bytes(n), tf32_flops=self.flops(n))
        bound = rl.step_time_s()
        util = None
        if dt_s is not None and dt_s > 0.0:
            util = bound / dt_s
        kscans = n if self.unit == "kscan" else -(-n // self.k)
        return RoundWork(kscans=kscans, dist_evals=self.pair_evals(n),
                         flops=rl.tf32_flops, hbm_bytes=rl.hbm_bytes,
                         bound_s=bound, bottleneck=rl.bottleneck,
                         dt_s=dt_s, utilization=util, unit=self.unit)

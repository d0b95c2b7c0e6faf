"""Carry state from the JAX package into the port.

`state_from_numpy` takes a JAX `KMeansState` whose leaves are numpy
arrays (as ``jax.tree.map(np.asarray, state)`` gives) and returns the
port's `KMeansState` on ``device``; `codebook_from_numpy` does the same
for a fitted codebook (centroids and counts). The tests use them to start
one round from the same state in both packages. Only attribute access is
used, so this module imports nothing of the JAX package.

``device`` defaults to ``"cuda"``, as the estimator's does, and raises
where there is no card (`resolve_device`); pass ``device="cpu"`` for the
CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import (ClusterStats, ElkanBounds, KMeansState,
                                   PointState)
from repro_torch.kernels._build import resolve_device


def _t(x, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(
        device=device, dtype=dtype)


def state_from_numpy(tree, device="cuda") -> KMeansState:
    """The port's `KMeansState` for a numpy-leaved JAX `KMeansState`."""
    device = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    s, p = tree.stats, tree.points
    stats = ClusterStats(C=_t(s.C, f32, device), S=_t(s.S, f32, device),
                         v=_t(s.v, f32, device), sse=_t(s.sse, f32, device),
                         p=_t(s.p, f32, device))
    points = PointState(a=_t(p.a, i32, device), d=_t(p.d, f32, device),
                        lb=_t(p.lb, f32, device))
    elkan = (None if tree.elkan is None
             else ElkanBounds(l=_t(tree.elkan.l, f32, device)))
    return KMeansState(stats=stats, points=points, elkan=elkan,
                       round=_t(tree.round, i32, device))


def codebook_from_numpy(C, counts, device="cuda") -> ClusterStats:
    """`ClusterStats` of a fitted codebook: S = C * counts, so S/v = C
    wherever a count is positive; sse and p start at 0."""
    device = resolve_device(device)
    Ct = _t(np.asarray(C, np.float32), torch.float32, device)
    v = _t(np.asarray(counts, np.float32), torch.float32, device)
    zeros = torch.zeros_like(v)
    return ClusterStats(C=Ct, S=Ct * v[:, None], v=v, sse=zeros,
                        p=zeros.clone())

"""Carry state from the JAX package into the port.

`state_from_numpy` takes a JAX `KMeansState` whose leaves are numpy
arrays (as ``jax.tree.map(np.asarray, state)`` gives) and returns the
port's `KMeansState` on ``device``; `codebook_from_numpy` does the same
for a fitted codebook (centroids and counts). The tests use them to start
one round from the same state in both packages. `outcome_from_numpy`
carries a whole JAX `FitOutcome` over, so that a serving process can
`adopt` a codebook the JAX package fitted. `params_from_numpy` carries a
model's parameter tree over (every family), so that both packages
compute with the same weights, and `opt_state_from_numpy` its AdamW
state, so that a training run carries across (on a mesh,
`repro_torch.models.sharding.shard_tree` then lays each tree out as the
rank's blocks, and `gather_tree` puts them back). Only attribute access and the
records' `to_dict` forms are used, so this module imports nothing of the
JAX package.

``device`` defaults to ``"cuda"``, as the estimator's does, and raises
where there is no card (`resolve_device`); pass ``device="cpu"`` for the
CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.config import FitConfig
from repro_torch.api.loop import FitOutcome
from repro_torch.api.telemetry import Telemetry
from repro_torch.core.state import (ClusterStats, ElkanBounds, KMeansState,
                                   PointState)
from repro_torch.kernels._build import resolve_device
from repro_torch.optim.adamw import AdamWState
from repro_torch.util.tree import tree_map


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


def outcome_from_numpy(outcome, device="cuda") -> FitOutcome:
    """The port's `FitOutcome` for a JAX `FitOutcome`: the state through
    `state_from_numpy` on ``device`` (its leaves may be numpy or JAX
    arrays), telemetry and config through their ``to_dict`` forms. The
    JAX package's ``kernel_backend="pallas"`` becomes "cuda" (the hand
    kernels); ``kernel_plan`` says which kernels made the fit and is kept
    as it was."""
    cfg = outcome.config.to_dict()
    if cfg.get("kernel_backend") == "pallas":
        cfg["kernel_backend"] = "cuda"
    return FitOutcome(
        C=np.array(outcome.C, dtype=np.float32, copy=True),
        state=state_from_numpy(outcome.state, device),
        labels=np.array(outcome.labels, copy=True),
        telemetry=[Telemetry.from_dict(r.to_dict())
                   for r in outcome.telemetry],
        converged=bool(outcome.converged),
        algorithm=str(outcome.algorithm),
        config=FitConfig.from_dict(cfg),
        kernel_plan=(None if outcome.kernel_plan is None
                     else dict(outcome.kernel_plan)))


def _tensor(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device``. numpy has no bfloat16: a
    JAX bf16 array comes as an ``ml_dtypes.bfloat16`` array, which
    `torch.from_numpy` refuses, so it is bit-cast through int16."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(x).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    """The port's parameter tree for a JAX model's (``jax.tree.map(
    np.asarray, params)``), leaf for leaf with the same dtypes and shapes
    (blocks stacked over periods and keyed by period position, as in
    both packages; bf16 leaves bf16, the router's and the SSD's f32 ones
    f32), the encdec family's ``encoder``, ``enc_in``, ``xattn`` and
    ``ln_x`` among them."""
    device = resolve_device(device)
    return tree_map(lambda x: _tensor(x, device), tree)


def opt_state_from_numpy(state, device="cuda"):
    """The port's `AdamWState` for a JAX `AdamWState` whose leaves are
    numpy arrays (``jax.tree.map(np.asarray, opt_state)``): f32 moments
    leaf for leaf and the 0-d int32 ``count``, on ``device``."""
    device = resolve_device(device)
    return AdamWState(mu=tree_map(lambda x: _tensor(x, device), state.mu),
                      nu=tree_map(lambda x: _tensor(x, device), state.nu),
                      count=_tensor(state.count, device))

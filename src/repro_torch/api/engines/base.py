"""The `EngineRun` contract.

Port of `repro/api/engines/base.py`, single process only: an engine owns
data placement and the round functions; `EngineRun` is one fit in
flight. The host loop (`repro_torch.api.loop.run_loop`) is written
against this contract alone, and every quantity it branches on is either
a field of the resolved `FitConfig` or a scalar out of `RoundInfo`.

The process hooks, checkpoint capture/restore and the obs seam of the
JAX contract are not ported yet (ROADMAP Queue 1 items 6, 8 and 9).
"""
from __future__ import annotations

from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.api.config import FitConfig
from repro_torch.core.state import ClusterStats, KMeansState, RoundInfo
from repro_torch.kernels.plan import KernelPlan


class EngineRun:
    """One fit in flight: placed data + initial state + round executors.

    Subclasses set:
      state            initial KMeansState (on ``device``)
      b                initial batch size (global rows)
      b_max            largest batch
      n_shards         data shards (1 for local)
      n_active_target  info.n_active value meaning "full data active"
      orig_index       (n_storage,) int: original caller row held at
                       each internal storage row
      n_points         caller's dataset size
      kernel_plan      the fit's resolved `KernelPlan`
      device           the torch device every tensor of the fit lies on
    """
    state: KMeansState
    b: int
    b_max: int
    n_shards: int = 1
    n_active_target: int = 0
    orig_index: np.ndarray = None
    n_points: int = 0
    kernel_plan: Optional[KernelPlan] = None
    device: torch.device = torch.device("cpu")

    def nested_step(self, state: KMeansState, b: int,
                    capacity: Optional[int]
                    ) -> Tuple[KMeansState, RoundInfo]:
        raise NotImplementedError(
            f"{type(self).__name__} does not run the nested family")

    def lloyd_step(self, state: KMeansState
                   ) -> Tuple[KMeansState, RoundInfo]:
        raise NotImplementedError(
            f"{type(self).__name__} does not run lloyd")

    def mb_step(self, state: KMeansState, fixed: bool
                ) -> Tuple[KMeansState, RoundInfo]:
        raise NotImplementedError(
            f"{type(self).__name__} does not run mb/mbf")

    def eval_mse(self, state: KMeansState) -> Optional[float]:
        """Validation MSE of the current centroids (None: no val set)."""
        return None

    def host_points(self, state: KMeansState) -> np.ndarray:
        """The (n_storage,) assignment vector on the host."""
        return state.points.a.cpu().numpy()

    def fetch_stats(self, state: KMeansState) -> ClusterStats:
        """Cluster stats usable by the estimator after the fit."""
        return state.stats


@runtime_checkable
class Engine(Protocol):
    """An execution backend: owns data placement + round functions."""

    def begin(self, X, config: FitConfig, *, X_val=None,
              init_C: Optional[np.ndarray] = None,
              device: torch.device) -> EngineRun:
        """Shuffle/place ``X`` on ``device`` and build the initial state."""
        ...

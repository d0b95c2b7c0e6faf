"""The `EngineRun` contract.

Port of `repro/api/engines/base.py`, single process only: an engine owns
data placement and the round functions; `EngineRun` is one fit in
flight. The host loop (`repro_torch.api.loop.run_loop`) is written
against this contract alone, and every quantity it branches on is either
a field of the resolved `FitConfig` or a scalar out of `RoundInfo`.

Checkpoint capture/restore and the process hooks are here in their
single-process form (`repro/api/engines/base.py:155-220`): one process
is the coordinator, a barrier is a no-op and a flag is its own
replica. The obs seam is ROADMAP Queue 1 item 8, the multi-process
overrides item 9.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

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
      data_fingerprint JSON-safe content identity of the fitted dataset
                       (`repro_torch.data.store.dataset_fingerprint`);
                       written into checkpoint extras so a resume
                       against a different dataset fails loudly. None
                       disables the check.
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
    data_fingerprint: Optional[Dict[str, Any]] = None

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

    def store_metrics(self) -> Optional[Dict[str, Any]]:
        """Cumulative chunk-store read metrics as a JSON-safe dict, or
        None when this run is not store-backed."""
        return None

    # -- checkpointing (canonical = global-shuffle row order) ---------------

    def capture(self, state: KMeansState) -> Tuple[Dict[str, Any],
                                                   Dict[str, Any]]:
        """(tree of tensors and arrays, JSON-safe engine meta) for a
        checkpoint; `CheckpointStore.save` copies the tree to the host.

        Per-point arrays are in CANONICAL order: the position of each
        row in the seed-determined shuffle. The tree's keys and the meta
        are the JAX package's, so either package restores the other's
        checkpoints.
        """
        raise NotImplementedError

    def restore(self, store: Any, step: int,
                meta: Dict[str, Any]) -> KMeansState:
        """Rebuild this run's state (on ``device``) from a canonical
        checkpoint."""
        raise NotImplementedError

    # -- process awareness (single-process forms) ---------------------------

    #: True on the process allowed to touch the checkpoint directory.
    is_coordinator: bool = True

    def barrier(self) -> None:
        """Block until every process reaches this point (one process:
        returns at once). The loop calls it around checkpoint writes."""

    def sync_flag(self, flag: bool) -> bool:
        """The coordinator's value of a host-derived flag (the wall-clock
        budget); one process: the flag itself."""
        return bool(flag)

    def resolve_resume(self, store: Any
                       ) -> Tuple[Optional[int], Optional[Dict[str, Any]]]:
        """(latest step, its ``extra`` dict); ``(None, None)`` when the
        store holds no checkpoints."""
        step = store.latest_step()
        if step is None:
            return None, None
        return step, store.read_extra(step)


@runtime_checkable
class Engine(Protocol):
    """An execution backend: owns data placement + round functions."""

    def begin(self, X, config: FitConfig, *, X_val=None,
              init_C: Optional[np.ndarray] = None,
              device: torch.device) -> EngineRun:
        """Shuffle/place ``X`` on ``device`` and build the initial state."""
        ...

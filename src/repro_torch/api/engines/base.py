"""The `EngineRun` contract.

Port of `repro/api/engines/base.py`: an engine owns data placement and
the round functions; `EngineRun` is one fit in flight. The host loop
(`repro_torch.api.loop.run_loop`) is written against this contract
alone, and every quantity it branches on is either a field of the
resolved `FitConfig` or a scalar out of `RoundInfo`.

Checkpoint capture/restore and the process hooks are here in their
single-process form (`repro/api/engines/base.py:155-220`): one process
is the coordinator, a barrier is a no-op and a flag is its own replica.
The mesh engines, one rank per process, override them with collectives
(`api/engines/mesh.py`). The validation MSE is taken here for every
engine: the centroids are the same bits on every rank, so it needs no
collective (an engine that shards the stats makes them whole in
`fetch_stats`). The audit seam, `LoopAudit` (defined here and
re-exported by `api.loop`, whose `run_loop` binds it through
`bind_audit`), lets an engine's body bracket its mid-fit uploads for the
fit's audit; its no-op instance is a run's default. The loop's obs seam,
`ObsSink`, is defined here too; an engine reports its spans through
`repro_torch.obs.span`, which writes to whatever sink the thread has
bound.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.api.config import FitConfig
from repro_torch.core.state import (ClusterStats, KMeansState, RoundInfo,
                                    full_mse)
from repro_torch.kernels.plan import KernelPlan


class LoopAudit:
    """Instrumentation seam for `repro_torch.analysis.hostsync`.

    `run_loop` brackets every round body with ``round_scope()`` and each
    sanctioned crossing inside it with ``sanctioned_scope(what)``, where
    ``what`` is one of:

      * ``"round_info"`` — the `fetch_round_info` scalar landing;
      * ``"eval_mse"``   — validation eval at the configured cadence;
      * ``"sync_flag"``  — the coordinator's wall-clock flag;
      * ``"checkpoint"`` — `run.capture` and the store write;
      * ``"upload"``     — a host->device copy of data the engine places
                           mid-fit (`_LocalRun._ensure_prefix`'s store
                           segments, mb's permutation), entered by the
                           engine through `EngineRun.bind_audit`. From
                           pageable memory such a copy waits for the
                           stream, which the card's sync-debug mode
                           reports; the JAX package leaves host->device
                           ungated altogether.

    The default scopes are no-ops, so production fits pay nothing. The
    host-sync auditor subclasses this to record every OTHER
    synchronisation inside the round scope as a violation.
    """

    def round_scope(self):
        return contextlib.nullcontext()

    def sanctioned_scope(self, what: str):
        return contextlib.nullcontext()


_NULL_AUDIT = LoopAudit()


class ObsSink:
    """Observability seam for `repro_torch.obs`, sibling of `LoopAudit`.

    `run_loop` hands every completed round's HOST-landed scalars (the
    `HostRoundInfo`, the schedule's b/capacity/patience values, the
    round's wall time and work clock, the chunk store's read counters)
    to ``round_end`` and notes overflow retries with ``count``. Spans
    (eval, checkpoint, store ingest, the round's parts) are not the
    sink's: `repro_torch.obs.span` times them always, and writes them
    through the ``span`` of the sink bound to the thread
    (`repro_torch.obs.observe`; `run_loop` binds its ``obs``), which this
    base class has none of.

    The base class is a no-op, so untraced fits pay a few method calls a
    round. The real sink is `repro_torch.obs.FitObserver`, which this
    seam does not import: it consumes only values that already crossed
    at a sanctioned point, so tracing adds no synchronisation (the
    host-sync auditor runs with tracing on to show it).
    """

    def count(self, name: str, n: int = 1) -> None:
        pass

    def round_end(self, round: int, hinfo: "HostRoundInfo",
                  **attrs) -> None:
        pass

    def fit_end(self, **summary) -> None:
        pass

    def close(self) -> None:
        pass


_NULL_OBS = ObsSink()


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

    #: the validation rows on ``device`` (None: no validation set)
    _Xv: Optional[torch.Tensor] = None

    def eval_mse(self, state: KMeansState) -> Optional[float]:
        """Validation MSE of the current centroids (None: no val set)."""
        if self._Xv is None:
            return None
        return float(full_mse(self._Xv, self.fetch_stats(state).C))

    def host_points(self, state: KMeansState) -> np.ndarray:
        """The (n_storage,) assignment vector on the host."""
        return state.points.a.cpu().numpy()

    def fetch_stats(self, state: KMeansState) -> ClusterStats:
        """The whole cluster stats (every centroid), usable by the
        estimator after the fit; an engine that shards them gathers
        them."""
        return state.stats

    # -- audit (see api.loop; default: no-op) -------------------------------

    #: the bound audit; engine bodies call
    #: ``self._audit.sanctioned_scope(...)`` unconditionally
    _audit: "LoopAudit" = _NULL_AUDIT

    def bind_audit(self, audit: Any) -> None:
        """Attach the fit's `LoopAudit` (called by `run_loop` before
        round 0). The engine enters ``sanctioned_scope("upload")`` around
        each host->device copy of data it places mid-fit."""
        self._audit = audit if audit is not None else _NULL_AUDIT

    def store_metrics(self) -> Optional[Dict[str, Any]]:
        """Cumulative chunk-store read metrics as a JSON-safe dict, or
        None when this run is not store-backed. Host-side counters only:
        reading them touches no device."""
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

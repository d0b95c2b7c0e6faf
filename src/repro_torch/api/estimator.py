"""`NestedKMeans`: the sklearn-style front door of the port.

    from repro_torch.api import FitConfig, NestedKMeans

    km = NestedKMeans(FitConfig(k=50, b0=5000)).fit(X_train, X_val=X_val)
    labels = km.predict(X_new)

Port of `repro/api/estimator.py`. `fit` runs every algorithm of
`config.ALGORITHMS` and every bound family of `config.BOUNDS`, from an
array or (tb and gb) from an on-disk chunk store, and resumes from the
checkpoints of either package. The estimator runs on ``device``, "cuda"
unless the caller asks for another: with no card it raises, it never
falls back to the CPU. ``backend="mesh"`` and ``backend="xl"`` (with a
``mesh``; xl's shards the centroids over its model dim) and
``backend="multihost"`` fit over the ranks of a process group: every
rank builds the same estimator and calls it with the same arguments.
`partial_fit` folds one batch into the running statistics with one
nested round on any of these backends, as in the JAX package; `adopt`,
`export_codebook` and `stats_` serve `repro_torch.serve`.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.config import FitConfig
from repro_torch.api.engines import Engine, make_engine
from repro_torch.api.loop import FitOutcome, fetch_round_info, run_loop
from repro_torch.api.telemetry import RoundCallback, Telemetry, final_val_mse
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import rounds
from repro_torch.core.state import ClusterStats, full_mse, init_state
from repro_torch.data.store import ChunkStore
from repro_torch.kernels import ops, ref
from repro_torch.kernels._build import resolve_device
from repro_torch.kernels.plan import resolve_plan

# config fields that must agree between a checkpoint manifest and the
# resuming config for the restored state to be meaningful (max_rounds /
# budgets / backend may all change across a restart)
_RESUME_KEYS = ("k", "algorithm", "rho", "b0", "bounds", "seed",
                "use_shalf", "shuffle")


class NotFittedError(RuntimeError):
    pass


class NestedKMeans:
    """Estimator over a `FitConfig` on one torch device.

    After `fit` / `partial_fit`:
      cluster_centers_   (k, d) float32 ndarray
      labels_            (n,) assignments of the fitted data (fit only)
      inertia_           batch MSE at the last round
      telemetry_         List[Telemetry], one per host round
      converged_         bool
      n_rounds_          len(telemetry_)

    Thread-safety: `fit` / `partial_fit` / `adopt` serialise on an
    internal lock, so a background refresher may stream batches while
    other threads call `predict` / `transform`. The readers never take
    the lock: they load ``_stats`` once and work on that `ClusterStats`,
    which is replaced whole and never changed in place (every round
    returns new C, S and v tensors). `export_codebook` copies the
    codebook to the host under the same lock for `repro_torch.serve`.
    """

    def __init__(self, config: FitConfig, *, mesh=None, device="cuda",
                 engine: Optional[Engine] = None,
                 on_round: Optional[RoundCallback] = None):
        self.config = config
        self.device = resolve_device(device)
        self.engine = engine or make_engine(config, mesh=mesh)
        self.on_round = on_round
        self.telemetry_: List[Telemetry] = []
        self._outcome: Optional[FitOutcome] = None
        self._stats: Optional[ClusterStats] = None
        self._outcome_stale = False
        # serialises the WRITERS (fit/partial_fit/adopt); readers load
        # self._stats once and work on that ClusterStats
        self._lock = threading.RLock()

    # -- fitting ------------------------------------------------------------

    def fit(self, X=None, *, X_val=None,
            init_C: Optional[np.ndarray] = None,
            resume: bool = False) -> "NestedKMeans":
        """Run the configured algorithm to convergence / budget.

        ``X`` may be an in-memory array, an on-disk chunk-store path (or
        open `ChunkStore`) for an out-of-core fit, or omitted when
        ``config.data_source`` names the store. Store-backed fits copy
        the nested prefix from disk onto the device as it grows, and
        are bit-identical to the in-memory fit over the same row
        sequence (nested family only: mb and lloyd rescan the full
        dataset every round).

        ``resume=True`` (requires ``config.checkpoint``) restores the
        latest in-loop checkpoint from ``checkpoint_dir`` (written by
        either package) and continues the fit from there,
        bit-identically. With no checkpoint on disk yet the fit starts
        fresh. Resuming against a different dataset than the
        checkpoint's is a loud error (the manifest carries a dataset
        fingerprint).
        """
        with self._lock:
            if X is None:
                if self.config.data_source is None:
                    raise ValueError(
                        "fit() needs data: pass X (array or store "
                        "path), or set config.data_source")
                X = self.config.data_source
            if isinstance(X, (str, os.PathLike)):
                X = ChunkStore(X)
            n = X.n if isinstance(X, ChunkStore) else len(X)
            cfg = self.config.resolve(n)
            if isinstance(X, ChunkStore) and cfg.algorithm not in (
                    "tb", "gb"):
                raise ValueError(
                    f"out-of-core fits stream the nested prefix; "
                    f"algorithm={self.config.algorithm!r} needs the "
                    f"full dataset in memory every round (pass X as an "
                    f"array)")
            if resume and cfg.checkpoint is None:
                raise ValueError(
                    "fit(resume=True) requires config.checkpoint")
            run = self.engine.begin(X, cfg, X_val=X_val, init_C=init_C,
                                    device=self.device)
            obs = None
            if cfg.trace_dir is not None:
                # built lazily so untraced fits never import
                # repro_torch.obs; each rank of a mesh fit writes its own
                # files
                from repro_torch.obs import FitObserver
                obs = FitObserver(
                    cfg.trace_dir,
                    process_id=dist.get_rank() if dist.is_initialized()
                    else 0, k=cfg.k,
                    d=int(run.state.stats.C.shape[-1]), bounds=cfg.bounds,
                    meta={"backend": cfg.backend,
                          "algorithm": cfg.algorithm,
                          "bounds": cfg.bounds,
                          "n_points": run.n_points,
                          "n_shards": run.n_shards, "seed": cfg.seed})
            resume_from = None
            resolved = None
            if resume:
                store = CheckpointStore(cfg.checkpoint.checkpoint_dir,
                                        keep=cfg.checkpoint.keep)
                step, extra = run.resolve_resume(store)
                if step is not None:
                    saved = (extra or {}).get("config")
                    if saved:
                        want = cfg.to_dict()
                        bad = [k for k in _RESUME_KEYS
                               if k in saved and saved[k] != want[k]]
                        if bad:
                            raise ValueError(
                                f"checkpoint manifest disagrees with the "
                                f"resuming config on {bad}; refusing to "
                                f"restore a foreign fit")
                    resume_from = store
                    resolved = (step, extra)
            try:
                out = run_loop(run, cfg, on_round=self.on_round,
                               resume_from=resume_from,
                               resolved_resume=resolved, obs=obs)
            finally:
                if obs is not None:
                    obs.close()
            self._outcome = out
            self._stats = out.state.stats
            self._outcome_stale = False
            self.telemetry_ = list(out.telemetry)
            return self

    def partial_fit(self, X) -> "NestedKMeans":
        """Fold one streaming batch into the codebook (one nested round).

        The incoming points enter unseen (``a == -1``): the round assigns
        them, adds them to S/v and moves the centroids to the updated
        means.

        On the mesh backends the batch is placed as a fit would place it
        (shuffle, interleave and structural pads, which the round masks
        out) and one full-prefix sharded round runs with the running
        statistics carried in (`EngineRun.place_stats`, which takes the
        rank's k-slice on xl); every rank passes the same batch.
        """
        with self._lock:
            X = np.asarray(X)
            cfg = self.config.resolve(int(X.shape[0]))
            if self._stats is None and X.shape[0] < cfg.k:
                raise ValueError(f"first partial_fit batch must have >= "
                                 f"k={cfg.k} rows")
            t_prev = self.telemetry_[-1].t if self.telemetry_ else 0.0
            t0 = time.perf_counter()
            if cfg.backend == "local":
                Xd = torch.from_numpy(np.ascontiguousarray(
                    X, dtype=np.float32)).to(self.device)
                state = init_state(Xd, cfg.k, bounds=cfg.bounds)
                if self._stats is not None:
                    # carry the running statistics; the bounds restart
                    # per batch (new points have no history to bound
                    # against)
                    state = dataclasses.replace(state, stats=self._stats)
                plan = resolve_plan(cfg.kernel_backend, b=int(X.shape[0]),
                                    k=cfg.k, d=int(X.shape[1]),
                                    device=self.device, bounds=cfg.bounds)
                new_state, info = rounds.nested_round(
                    Xd, state, b=int(X.shape[0]), rho=cfg.rho,
                    bounds=cfg.bounds, capacity=None,
                    use_shalf=cfg.use_shalf, plan=plan)
            else:
                run = self.engine.begin(
                    X, cfg, device=self.device,
                    init_C=(self._stats.C.cpu().numpy()
                            if self._stats is not None else None))
                state = run.state
                if self._stats is not None:
                    state = run.place_stats(state, self._stats)
                new_state, info = run.nested_step(state, run.b_max, None)
                # whole: the XL engine's round leaves a k-slice a rank
                new_state = dataclasses.replace(
                    new_state, stats=run.fetch_stats(new_state))
            hinfo = fetch_round_info(info)
            self._stats = new_state.stats
            if self._outcome is not None:
                self._outcome_stale = True
            rec = Telemetry.from_round(
                hinfo, round=len(self.telemetry_),
                t=t_prev + time.perf_counter() - t0)
            self.telemetry_.append(rec)
            if self.on_round:
                self.on_round(rec)
            return self

    def adopt(self, outcome: FitOutcome) -> "NestedKMeans":
        """Rehydrate this estimator from a previously produced outcome.

        Lets a serving process rebuild an estimator from a `FitOutcome`
        computed elsewhere (by `repro_torch.api.fit` in a training job,
        or by the JAX package through `convert.outcome_from_numpy`) and
        keep streaming into it with `partial_fit`. The statistics are
        placed on this estimator's device.
        """
        if outcome.config.k != self.config.k:
            raise ValueError(
                f"cannot adopt an outcome fitted with "
                f"k={outcome.config.k} into an estimator configured "
                f"for k={self.config.k}")
        s = outcome.state.stats
        stats = ClusterStats(*(t.to(self.device) for t in (
            s.C, s.S, s.v, s.sse, s.p)))
        with self._lock:
            self._outcome = outcome
            self._stats = stats
            self._outcome_stale = False
            self.telemetry_ = list(outcome.telemetry)
            return self

    def export_codebook(self) -> Dict[str, Any]:
        """Atomic host-side copy of the codebook, for snapshot publishers.

        Returns ``{"centroids", "counts", "n_rounds", "batch_mse"}``
        captured under the writer lock, so a concurrent `partial_fit`
        can never be observed half-applied. The arrays are fresh numpy
        copies owned by the caller.
        """
        with self._lock:
            stats = self._require_fitted()
            return {
                "centroids": np.array(stats.C.cpu().numpy(),
                                      dtype=np.float32, copy=True),
                "counts": np.array(stats.v.cpu().numpy(),
                                   dtype=np.float32, copy=True),
                "n_rounds": len(self.telemetry_),
                "batch_mse": self.inertia_,
            }

    # -- fitted attributes --------------------------------------------------

    def _require_fitted(self) -> ClusterStats:
        stats = self._stats
        if stats is None:
            raise NotFittedError("call fit() or partial_fit() first")
        return stats

    @property
    def cluster_centers_(self) -> np.ndarray:
        return self._require_fitted().C.cpu().numpy()

    @property
    def counts_(self) -> np.ndarray:
        """Per-cluster membership counts v (codebook occupancy)."""
        return self._require_fitted().v.cpu().numpy()

    @property
    def stats_(self) -> ClusterStats:
        """The running `ClusterStats` (C/S/v/sse/p) on the estimator's
        device: what `adopt` placed or the last fit / partial_fit made."""
        return self._require_fitted()

    def _require_fresh_outcome(self, what: str) -> FitOutcome:
        if self._outcome is None:
            raise NotFittedError(f"{what} requires a full fit()")
        if self._outcome_stale:
            raise NotFittedError(
                f"{what} is stale: partial_fit() has moved the centroids "
                f"since fit(); use predict(X) for fresh assignments")
        return self._outcome

    @property
    def labels_(self) -> np.ndarray:
        """Assignments of the fitted data, in the caller's row order
        (-1 = row never entered the nested batch)."""
        self._require_fitted()
        return self._require_fresh_outcome("labels_").labels

    @property
    def inertia_(self) -> float:
        self._require_fitted()
        for rec in reversed(self.telemetry_):
            if rec.batch_mse is not None:
                return rec.batch_mse
        return float("nan")

    @property
    def converged_(self) -> bool:
        return self._outcome.converged if self._outcome else False

    @property
    def n_rounds_(self) -> int:
        return len(self.telemetry_)

    @property
    def outcome_(self) -> FitOutcome:
        self._require_fitted()
        return self._require_fresh_outcome("outcome_")

    @property
    def final_mse_(self) -> float:
        return final_val_mse(self.telemetry_)

    # -- inference ----------------------------------------------------------

    def _on_device(self, X) -> torch.Tensor:
        if isinstance(X, torch.Tensor):
            return X.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(X)).to(self.device)

    def predict(self, X) -> np.ndarray:
        """Nearest-centroid index (int32) for each row of ``X``."""
        stats = self._require_fitted()
        Xd = self._on_device(X).float()
        plan = resolve_plan(self.config.kernel_backend, b=Xd.shape[0],
                            k=stats.C.shape[0], d=Xd.shape[1],
                            device=self.device)
        a, _, _ = ops.assign_top2(Xd, stats.C, plan=plan)
        return a.cpu().numpy()

    def transform(self, X) -> np.ndarray:
        """Euclidean distance of each row to every centroid: (n, k)."""
        stats = self._require_fitted()
        d2 = ref.pairwise_dist2(self._on_device(X), stats.C)
        return torch.sqrt(torch.clamp_min(d2, 0.0)).cpu().numpy()

    def score(self, X) -> float:
        """Negative inertia (-sum of squared distances), sklearn-style."""
        stats = self._require_fitted()
        Xd = self._on_device(X)
        return -float(full_mse(Xd, stats.C)) * int(Xd.shape[0])

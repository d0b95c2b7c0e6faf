"""`MeshEngine`: the nested rounds over the ranks of a `DeviceMesh`.

Port of `repro/api/engines/mesh.py`. JAX's mesh engine is one process
that drives several devices; the port's mesh has one process per rank
(`repro_torch.launch.mesh`), so `_MeshRun` has the shape of JAX's
`_MultiHostRun` (`repro/api/engines/multihost.py`):

  * placement: every rank holds only its own shard's rows, taken
    straight out of the shared `nested_shard_layout`
    (`ShardLayout.shard_orig_rows`) into its own ``(rows_per_shard, d)``
    device buffer; pads are copies of ``X[0]``. No rank builds the
    padded, permuted copy of the whole dataset. The stats are
    replicated: the round all-reduces the S/v/sse deltas
    (`core/distributed.py::make_sharded_round`), so the centroids and
    the growth decision are the same bits on every rank.
  * host views: a row-sharded leaf is whole only after an all-gather
    over the data dims (`_fetch`, `collectives.gather_rows`); `_canon`
    then un-interleaves it into canonical (shuffle-position) order.
  * the stats seams: a rank holds the k-slice `_k_rows` of the stats
    (here all of k) and `_whole_k` makes a k-sharded leaf whole (here
    the identity). The XL engine (`api/engines/xl.py`) shards the stats
    over a model dim through these two alone: every view of the stats
    that leaves the run (`fetch_stats`, so `eval_mse`, the outcome's
    centroids and the estimator's codebook; `capture`) is whole, and
    `place_stats` and `restore` take this rank's slice of whole stats.
  * process hooks: rank 0 is the coordinator and the only writer of
    checkpoints; `barrier`, `sync_flag` and `resolve_resume` are
    collectives, and the coordinator reads a checkpoint and broadcasts
    it. Every rank runs the same host loop over the same schedule
    (`repro_torch.api.loop`'s replicated control flow).

Checkpoints are the local engine's canonical tree and meta, so a
checkpoint moves between local, mesh and any rank count, in either
package. Out of core, each rank fills its own buffer in place from a
`StoredShardSource`, only as far as the nested prefix has grown.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api.config import FitConfig
from repro_torch.api.engines.base import EngineRun
from repro_torch.api.engines.local import _IO_SEG_ROWS
from repro_torch.core import collectives
from repro_torch.core.distributed import make_sharded_round
from repro_torch.core.state import (ClusterStats, ElkanBounds, KMeansState,
                                    PointState, init_state)
from repro_torch.data.pipeline import nested_shard_layout
from repro_torch.data.store import (ChunkStore, StoredShardSource,
                                    dataset_fingerprint)
from repro_torch.kernels.plan import resolve_plan
from repro_torch.launch.mesh import rank_device


class _MeshRun(EngineRun):
    _engine_name = "mesh"

    def __init__(self, X, config: FitConfig, mesh, X_val, init_C, device):
        data_axes = tuple(config.data_axes)
        n_shards = math.prod(collectives.axis_size(mesh, ax)
                             for ax in data_axes)
        self.device = rank_device(device)
        self._config = config
        self._mesh = mesh
        self._data_axes = data_axes
        self._world = dist.get_world_size()
        # this rank's shard: row-major over the data dims, the slice
        # order of JAX's P(data_axes, None)
        self._shard = collectives.linear_index(mesh, data_axes)
        if isinstance(X, ChunkStore):
            # out of core: the layout's shuffle is the store's
            # chunk-blocked permutation; rows are read lazily up to the
            # nested prefix (`_ensure_prefix`)
            self._src = StoredShardSource(X, n_shards, seed=config.seed,
                                          shuffle=config.shuffle)
            n_real, dim = X.n, X.d
            lay = self._src.layout
            self.data_fingerprint = X.fingerprint()
        else:
            self._src = None
            X = np.asarray(X)
            n_real, dim = X.shape
            lay = nested_shard_layout(n_real, n_shards, seed=config.seed,
                                      shuffle=config.shuffle)
            # on the caller's array, before the shuffle, as in JAX
            self.data_fingerprint = dataset_fingerprint(X)
        self._layout = lay
        rps = lay.rows_per_shard
        self.n_shards = n_shards
        self.n_points = n_real
        self.n_active_target = n_real
        self.b = max(1, min(config.b0, n_real) // n_shards)
        # every shard's real rows are a prefix of its storage slice; the
        # shards that end in a structural pad cap their prefix with the
        # per-shard n_valid mask inside the round, so b_max covers every
        # real row, the tail rows of the low shards included
        self.b_max = max(1, rps)
        self._n_real = n_real if n_real % n_shards else None
        self.orig_index = lay.orig_index()
        # storage row r holds shuffle position pos[r]: the canonical
        # (shuffle-position) order of the gathered rows, pads cut
        self._canon_idx = torch.from_numpy(
            np.argsort(lay.pos)[:n_real]).to(self.device)
        self._Xv = (torch.from_numpy(np.ascontiguousarray(
            X_val, dtype=np.float32)).to(self.device)
            if X_val is not None else None)
        if self._src is None:
            rows = lay.shard_orig_rows(self._shard)
            self._Xd = torch.from_numpy(np.ascontiguousarray(
                X[np.where(rows >= 0, rows, 0)], dtype=np.float32)).to(
                self.device)
            self._filled = rps
        else:
            self._Xd = torch.zeros((rps, dim), dtype=torch.float32,
                                   device=self.device)
            self._filled = 0
        if init_C is not None:
            C0 = np.asarray(init_C, np.float32)
        else:
            # the paper's init: the first k of the global shuffle (k >
            # n_real only: positions past it are pads, copies of X[0])
            idx = lay.perm[:config.k]
            idx = np.where(idx < n_real, idx, 0)
            C0 = (self._src.store.take(idx) if self._src is not None
                  else X[idx]).astype(np.float32)
        # one plan for the fit, at the per-shard bucket: the shapes the
        # kernels see on each rank
        self.kernel_plan = resolve_plan(config.kernel_backend, b=self.b_max,
                                        k=config.k, d=dim,
                                        device=self.device,
                                        bounds=config.bounds)
        state = init_state(self._Xd, config.k)
        C = torch.from_numpy(np.ascontiguousarray(C0)).to(self.device)
        state = self.place_stats(
            state, dataclasses.replace(state.stats, C=C))
        cols = self._k_rows()
        self.state = dataclasses.replace(state, elkan=(
            ElkanBounds(l=torch.zeros((rps, cols.stop - cols.start),
                                      dtype=torch.float32,
                                      device=self.device))
            if config.bounds == "elkan" else None))

    # -- out-of-core placement ----------------------------------------------

    def _fetch_block(self, lo: int, hi: int) -> np.ndarray:
        """This rank's storage rows [lo, hi) off the store, f32."""
        return self._src.block(np.asarray([self._shard]), lo, hi)[0] \
            .astype(np.float32, copy=False)

    def _ensure_prefix(self, b: int) -> None:
        """Copy this rank's rows [filled, b) off the store into its
        buffer in place, one segment at a time (`_LocalRun`'s pattern).
        No-op for in-memory fits and prefixes already filled."""
        if self._src is None or b <= self._filled:
            return
        with self._obs.span("ingest", rows=b - self._filled), \
                self._audit.sanctioned_scope("upload"):
            lo = self._filled
            while lo < b:
                hi = min(b, lo + _IO_SEG_ROWS)
                # from pageable memory: the copy is done when copy_
                # returns
                self._Xd[lo:hi].copy_(torch.from_numpy(
                    self._fetch_block(lo, hi)))
                lo = hi
            self._filled = b
            # warm the chunks of the next doubling while this round
            # computes
            self._src.prefetch_positions(
                b * self.n_shards, min(2 * b, self.b_max) * self.n_shards)

    def store_metrics(self):
        if self._src is None:
            return None
        return self._src.store.metrics.to_dict()

    # -- the round ------------------------------------------------------------

    def nested_step(self, state, b, capacity):
        self._ensure_prefix(b)
        round_fn = make_sharded_round(
            self._mesh, self._data_axes, b_local=b, rho=self._config.rho,
            bounds=self._config.bounds, capacity=capacity,
            use_shalf=self._config.use_shalf, n_real=self._n_real,
            plan=self.kernel_plan)
        return round_fn(self._Xd, state)

    # -- host views -----------------------------------------------------------

    def _fetch(self, arr: torch.Tensor) -> torch.Tensor:
        """A row-sharded leaf whole, in storage order, on every rank (one
        all-gather over the data dims); it stays on the device."""
        return collectives.gather_rows(arr, self._mesh, self._data_axes)

    def _canon(self, arr: torch.Tensor) -> torch.Tensor:
        """A row-sharded leaf in canonical order, pads cut."""
        return self._fetch(arr)[self._canon_idx]

    def host_points(self, state):
        return self._fetch(state.points.a).cpu().numpy()

    def _k_rows(self) -> slice:
        """The rows of the whole (k, ...) stats this rank holds: all of
        them, replicated."""
        return slice(0, self._config.k)

    def _whole_k(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """A leaf whose dim ``dim`` holds this rank's `_k_rows`, made
        whole along it (replicated: it is whole already)."""
        return t

    def fetch_stats(self, state) -> ClusterStats:
        """The whole stats, the same on every rank."""
        return ClusterStats(*(self._whole_k(getattr(state.stats, f.name))
                              for f in dataclasses.fields(ClusterStats)))

    def place_stats(self, state, stats: ClusterStats) -> KMeansState:
        """``state`` with this rank's `_k_rows` of the whole running
        ``stats`` on its device: the initial stats, a restore's, and the
        sharded `partial_fit`'s carry-in."""
        rows = self._k_rows()
        placed = ClusterStats(*(torch.as_tensor(getattr(stats, f.name))
                                [rows].to(self.device)
                                for f in dataclasses.fields(stats)))
        return dataclasses.replace(state, stats=placed)

    # -- checkpointing (canonical = global-shuffle row order) ---------------

    def capture(self, state):
        tree = {"stats": self.fetch_stats(state),
                "a": self._canon(state.points.a),
                "d": self._canon(state.points.d),
                "lb": self._canon(state.points.lb), "round": state.round}
        if state.elkan is not None:
            tree["elkan_l"] = self._canon(self._whole_k(state.elkan.l,
                                                        dim=1))
        meta = {"engine": self._engine_name, "n_shards": self.n_shards,
                "n_points": self.n_points, "has_mb": False,
                "has_elkan": state.elkan is not None}
        return tree, meta

    def _canonical_proto(self, meta):
        """Zero tree with the canonical checkpoint shapes and dtypes."""
        k, d, n = self._config.k, self._Xd.shape[1], self.n_points
        f32 = torch.float32
        proto = {
            "stats": ClusterStats(C=torch.zeros((k, d), dtype=f32),
                                  S=torch.zeros((k, d), dtype=f32),
                                  v=torch.zeros((k,), dtype=f32),
                                  sse=torch.zeros((k,), dtype=f32),
                                  p=torch.zeros((k,), dtype=f32)),
            "a": torch.zeros((n,), dtype=torch.int32),
            "d": torch.zeros((n,), dtype=f32),
            "lb": torch.zeros((n,), dtype=f32),
            "round": torch.zeros((), dtype=torch.int32),
        }
        if meta.get("has_elkan"):
            proto["elkan_l"] = torch.zeros((n, k), dtype=f32)
        return proto

    def _read_canonical(self, store, step, meta):
        """The canonical tree on the CPU: the coordinator reads it off
        its disk and broadcasts it, so the other ranks need not see the
        checkpoint directory."""
        proto = self._canonical_proto(meta)
        if self._world == 1:
            return store.restore(proto, step=step)
        box = [store.restore(proto, step=step) if self.is_coordinator
               else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def restore(self, store, step, meta):
        want_elkan = self._config.bounds == "elkan"
        if meta.get("has_elkan") and not want_elkan:
            raise ValueError(
                "checkpoint carries elkan bounds but this config does "
                "not use bounds='elkan'")
        if want_elkan and not meta.get("has_elkan"):
            raise ValueError(
                "config uses bounds='elkan' but the checkpoint carries "
                "no elkan bound state")
        host = self._read_canonical(store, step, meta)
        lay = self._layout
        # this rank's storage rows, as canonical positions
        mine = torch.from_numpy(lay.shard_positions(self._shard))

        def place(h, fill):
            # re-pad for THIS layout's shard count, then take this
            # rank's rows
            full = torch.full((lay.n_storage,) + tuple(h.shape[1:]), fill,
                              dtype=h.dtype)
            full[:self.n_points] = h
            return full[mine].to(self.device)

        stats = self.place_stats(self.state, host["stats"]).stats
        points = PointState(a=place(host["a"], -1), d=place(host["d"], 0.0),
                            lb=place(host["lb"], 0.0))
        elkan = (ElkanBounds(l=place(host["elkan_l"], 0.0)
                             [:, self._k_rows()].contiguous())
                 if want_elkan else None)
        return KMeansState(stats=stats, points=points, elkan=elkan,
                           round=host["round"].to(self.device))

    # -- process awareness (one rank per process) ---------------------------

    @property
    def is_coordinator(self) -> bool:
        return dist.get_rank() == 0

    def barrier(self) -> None:
        if self._world > 1:
            dist.barrier()

    def sync_flag(self, flag: bool) -> bool:
        if self._world == 1:
            return bool(flag)
        box = [bool(flag)]
        dist.broadcast_object_list(box, src=0)
        return bool(box[0])

    def resolve_resume(self, store):
        if self._world == 1:
            return super().resolve_resume(store)
        # the coordinator's filesystem is the source of truth: the step
        # and its metadata are broadcast, so every rank resumes the same
        # run even when the checkpoint directory is not shared
        box = [super().resolve_resume(store) if self.is_coordinator
               else None]
        dist.broadcast_object_list(box, src=0)
        return tuple(box[0])


class MeshEngine:
    """Points row-sharded over the data dims of ``mesh``, one rank per
    process; cluster stats replicated.

    The S/v/sse deltas are all-reduced inside the round, so the stats,
    and therefore the controller's growth decision, are the same bits on
    every rank with no host round trip. Only the nested (gb/tb) family
    runs; `FitConfig.__post_init__` enforces this. Every rank builds
    its engine and calls `begin` with the same dataset and config.
    """

    def __init__(self, mesh):
        self.mesh = mesh

    def begin(self, X, config: FitConfig, *, X_val=None, init_C=None,
              device="cuda") -> EngineRun:
        return _MeshRun(X, config, self.mesh, X_val, init_C, device)

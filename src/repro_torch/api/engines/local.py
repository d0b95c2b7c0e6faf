"""`LocalEngine`: single-process rounds on one device.

Port of `repro/api/engines/local.py`. In-memory rows are shuffled with
the same numpy permutation as the JAX engine
(``default_rng(seed).permutation(N)``), and mb's batches come from the
next permutations of the same generator, drawn in the same order, so
both packages see the same rows in the same order. A chunk store is
read lazily into a device buffer in `store_permutation`'s order, only as
far as the nested prefix has grown. The kernel plan is resolved once
per fit. `capture`/`restore` write and read the JAX engine's checkpoint
tree and meta. `LocalEngine.begin` is the ``engine.place`` span, with
``engine.fingerprint``, ``engine.shuffle`` and ``engine.upload`` inside
it (`repro_torch.obs.span`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.config import FitConfig
from repro_torch.api.engines.base import EngineRun
from repro_torch.core import rounds
from repro_torch.core.state import (ElkanBounds, KMeansState, PointState,
                                    init_state)
from repro_torch.data.store import (ChunkStore, dataset_fingerprint,
                                    store_permutation)
from repro_torch.kernels.plan import resolve_plan
from repro_torch.obs import span

# rows fetched off a ChunkStore per copy into the device buffer: bounds
# the host memory in flight
_IO_SEG_ROWS = 65536


class _LocalRun(EngineRun):
    def __init__(self, X, config: FitConfig, X_val, init_C,
                 device: torch.device):
        self.device = torch.device(device)
        rng = np.random.default_rng(config.seed)
        self._store = X if isinstance(X, ChunkStore) else None
        if self._store is not None:
            # out of core: a zero device buffer filled in place up to the
            # current nested prefix (`_ensure_prefix`); the host holds at
            # most one segment of rows at a time. Rounds read only the
            # filled prefix: dense rounds take X[:b], compacted rounds
            # gather rows below b.
            N = self._store.n
            perm = store_permutation(N, self._store.chunk_rows,
                                     config.seed, shuffle=config.shuffle)
            self._Xd = torch.zeros((N, self._store.d), dtype=torch.float32,
                                   device=self.device)
            self._filled = 0
            with span("engine.fingerprint"):
                self.data_fingerprint = self._store.fingerprint()
        else:
            X = np.asarray(X)
            N = X.shape[0]
            with span("engine.shuffle"):
                perm = (rng.permutation(N) if config.shuffle
                        else np.arange(N))
                rows = np.ascontiguousarray(X[perm], dtype=np.float32)
            with span("engine.upload"):
                self._Xd = torch.from_numpy(rows).to(self.device)
            del rows
            self._filled = N
            # on the caller's array, before the shuffle, as in JAX
            with span("engine.fingerprint"):
                self.data_fingerprint = dataset_fingerprint(X)
        self._Xv = None
        if X_val is not None:
            with span("engine.upload"):
                self._Xv = torch.from_numpy(np.ascontiguousarray(
                    X_val, dtype=np.float32)).to(self.device)
        self._config = config
        self._perm = perm
        if self._store is not None:
            # the paper's init needs the first k shuffled rows
            self._ensure_prefix(min(N, max(config.k, 1)))
        state = init_state(self._Xd, config.k, bounds=config.bounds)
        if init_C is not None:       # warm start
            C = torch.from_numpy(np.ascontiguousarray(
                init_C, dtype=np.float32)).to(self.device)
            state = dataclasses.replace(state, stats=dataclasses.replace(
                state.stats, C=C))
        self.state = state
        self.b = min(config.b0, N)
        self.b_max = N
        self.n_shards = 1
        self.n_active_target = N
        self.orig_index = perm        # storage row i holds X[perm[i]]
        self.n_points = N
        self.kernel_plan = resolve_plan(config.kernel_backend, b=N,
                                        k=config.k, d=self._Xd.shape[1],
                                        device=self.device,
                                        bounds=config.bounds)
        # mb/mbf resampling stream (the paper's footnote 1: cycle through
        # a reshuffle). Drawn here, after the shuffle, for every
        # algorithm, as the JAX engine draws it; the card gets a copy
        # once per permutation and each batch is a slice of that copy.
        self._rng = rng
        self._mb_pos = 0
        self._mb_perm = rng.permutation(N)
        self._mb_idx = None

    def _ensure_prefix(self, b: int) -> None:
        """Copy shuffled rows [filled, b) off the store into the device
        buffer in place, one segment at a time. No-op for in-memory fits
        and for prefixes already filled: only growth rounds read."""
        if self._store is None or b <= self._filled:
            return
        with span("ingest", rows=b - self._filled), \
                self._audit.sanctioned_scope("upload"):
            lo = self._filled
            while lo < b:
                hi = min(b, lo + _IO_SEG_ROWS)
                rows = self._store.take(self._perm[lo:hi]).astype(
                    np.float32, copy=False)
                # from pageable memory: the copy is done when copy_
                # returns, so the next segment's rows may be read into
                # fresh memory
                self._Xd[lo:hi].copy_(torch.from_numpy(rows))
                lo = hi
            self._filled = b

    def store_metrics(self):
        if self._store is None:
            return None
        return self._store.metrics.to_dict()

    def nested_step(self, state, b, capacity):
        self._ensure_prefix(b)
        return rounds.nested_round(
            self._Xd, state, b=b, rho=self._config.rho,
            bounds=self._config.bounds, capacity=capacity,
            use_shalf=self._config.use_shalf, plan=self.kernel_plan)

    def lloyd_step(self, state):
        return rounds.lloyd_round(self._Xd, state, plan=self.kernel_plan)

    def mb_step(self, state, fixed):
        N, b = self.b_max, self.b
        if self._mb_pos + b > N:
            self._mb_perm = self._rng.permutation(N)
            self._mb_pos = 0
            self._mb_idx = None
        if self._mb_idx is None:
            with self._audit.sanctioned_scope("upload"):
                self._mb_idx = torch.from_numpy(self._mb_perm).to(
                    self.device)
        idx = self._mb_idx[self._mb_pos:self._mb_pos + b]
        self._mb_pos += b
        return rounds.mb_round(self._Xd, idx, state, fixed=fixed,
                               plan=self.kernel_plan)

    # -- checkpointing ------------------------------------------------------
    # storage row i holds shuffle position i, so storage order IS the
    # canonical order for the local engine.

    def capture(self, state):
        tree = {"stats": state.stats, "a": state.points.a,
                "d": state.points.d, "lb": state.points.lb,
                "round": state.round, "mb_perm": self._mb_perm}
        if state.elkan is not None:
            tree["elkan_l"] = state.elkan.l
        meta = {
            "engine": "local", "n_shards": 1, "n_points": self.n_points,
            "has_mb": True, "has_elkan": state.elkan is not None,
            "mb_pos": self._mb_pos,
            "rng_state": self._rng.bit_generator.state,
        }
        return tree, meta

    def restore(self, store, step, meta):
        proto = {"stats": self.state.stats, "a": self.state.points.a,
                 "d": self.state.points.d, "lb": self.state.points.lb,
                 "round": self.state.round}
        if meta.get("has_elkan"):
            if self.state.elkan is None:
                raise ValueError(
                    "checkpoint carries elkan bounds but this config "
                    "does not use bounds='elkan'")
            proto["elkan_l"] = self.state.elkan.l
        if meta.get("has_mb"):
            proto["mb_perm"] = self._mb_perm
        got = store.restore(proto, step=step)      # on the CPU
        if meta.get("has_mb"):
            # int64, as rng.permutation draws it (a JAX restore may have
            # narrowed it to int32 before saving)
            self._mb_perm = got.pop("mb_perm").numpy().astype(np.int64)
            self._mb_pos = int(meta["mb_pos"])
            # the card's copy is of the permutation this run drew
            self._mb_idx = None
        if meta.get("rng_state") is not None:
            self._rng.bit_generator.state = meta["rng_state"]

        def on(t):
            return t.to(self.device)

        stats = got["stats"]
        stats = dataclasses.replace(stats, **{
            f.name: on(getattr(stats, f.name))
            for f in dataclasses.fields(stats)})
        points = PointState(a=on(got["a"]), d=on(got["d"]),
                            lb=on(got["lb"]))
        elkan = (ElkanBounds(l=on(got["elkan_l"]))
                 if meta.get("has_elkan") else None)
        return KMeansState(stats=stats, points=points, elkan=elkan,
                           round=on(got["round"]))


class LocalEngine:
    """Single-process engine."""

    def begin(self, X, config: FitConfig, *, X_val=None, init_C=None,
              device="cuda") -> EngineRun:
        with span("engine.place"):
            return _LocalRun(X, config, X_val, init_C, device)

"""`LocalEngine`: single-process rounds on one device.

Port of `repro/api/engines/local.py` for in-memory data. The rows are
shuffled with the same numpy permutation as the JAX engine
(``default_rng(seed).permutation(N)``), and mb's batches come from the
next permutations of the same generator, drawn in the same order, so
both packages see the same rows in the same order. The kernel plan is
resolved once per fit. Streaming rows from a chunk store is ROADMAP
Queue 1 item 6.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.api.config import FitConfig
from repro_torch.api.engines.base import EngineRun
from repro_torch.core import rounds
from repro_torch.core.state import full_mse, init_state
from repro_torch.kernels.plan import resolve_plan


def _is_store(X) -> bool:
    """A chunk-store path or an open chunk store."""
    return isinstance(X, (str, os.PathLike)) or hasattr(X, "chunk_rows")


class _LocalRun(EngineRun):
    def __init__(self, X, config: FitConfig, X_val, init_C,
                 device: torch.device):
        if _is_store(X) or config.data_source is not None:
            raise NotImplementedError(
                "fits from a chunk store are not ported to repro_torch "
                "yet (ROADMAP Queue 1 item 6); pass X as an array")
        X = np.asarray(X)
        N = X.shape[0]
        rng = np.random.default_rng(config.seed)
        perm = rng.permutation(N) if config.shuffle else np.arange(N)
        self.device = torch.device(device)
        self._Xd = torch.from_numpy(np.ascontiguousarray(
            X[perm], dtype=np.float32)).to(self.device)
        self._Xv = (torch.from_numpy(np.ascontiguousarray(
            X_val, dtype=np.float32)).to(self.device)
            if X_val is not None else None)
        self._config = config
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

    def nested_step(self, state, b, capacity):
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
            self._mb_idx = torch.from_numpy(self._mb_perm).to(self.device)
        idx = self._mb_idx[self._mb_pos:self._mb_pos + b]
        self._mb_pos += b
        return rounds.mb_round(self._Xd, idx, state, fixed=fixed,
                               plan=self.kernel_plan)

    def eval_mse(self, state):
        if self._Xv is None:
            return None
        return float(full_mse(self._Xv, state.stats.C))


class LocalEngine:
    """Single-process engine."""

    def begin(self, X, config: FitConfig, *, X_val=None, init_C=None,
              device="cuda") -> EngineRun:
        return _LocalRun(X, config, X_val, init_C, device)

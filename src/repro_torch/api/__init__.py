"""repro_torch.api — the public surface of the port.

    from repro_torch.api import FitConfig, NestedKMeans

    km = NestedKMeans(FitConfig(k=50, b0=5000)).fit(X_train, X_val=X_val)
    labels = km.predict(X_new)

`NestedKMeans` runs on ``device="cuda"`` unless told otherwise, and so
does `fit`, a functional form over it that returns the `FitOutcome`.
A mesh fit passes its `DeviceMesh`, and an xl fit a ``(data, model)``
one, whose model dim shards the centroids:

    km = NestedKMeans(dataclasses.replace(cfg, backend="mesh"),
                      mesh=my_mesh).fit(X)
    km = NestedKMeans(dataclasses.replace(cfg, backend="xl"),
                      mesh=make_host_mesh((2, 2), ("data", "model"))).fit(X)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.api.config import (ALGORITHMS, BACKENDS, BOUNDS,
                                    CheckpointConfig, FitConfig)
from repro_torch.api.engines import (Engine, EngineRun, LocalEngine,
                                     MeshEngine, MultiHostEngine, XLEngine,
                                     make_engine)
from repro_torch.api.estimator import NestedKMeans, NotFittedError
from repro_torch.api.loop import (FitOutcome, HostRoundInfo, cap_bucket,
                                  fetch_round_info, next_pow2, run_loop)
from repro_torch.api.telemetry import RoundCallback, Telemetry, final_val_mse


def fit(X, config: FitConfig, *, X_val=None, mesh=None,
        init_C: Optional[np.ndarray] = None,
        on_round: Optional[RoundCallback] = None,
        device="cuda") -> FitOutcome:
    """One-call fit: build the engine for ``config`` (on ``mesh`` for
    ``backend="mesh"`` and ``"xl"``) and run it.

    ``X``: an array, a chunk-store path or an open `ChunkStore`, passed
    through to `NestedKMeans.fit`."""
    km = NestedKMeans(config, mesh=mesh, device=device, on_round=on_round)
    km.fit(X, X_val=X_val, init_C=init_C)
    return km.outcome_


__all__ = [
    "FitConfig", "CheckpointConfig", "NestedKMeans", "NotFittedError",
    "fit",
    "Engine", "EngineRun", "LocalEngine", "MeshEngine", "MultiHostEngine",
    "XLEngine", "make_engine",
    "run_loop", "FitOutcome", "HostRoundInfo", "fetch_round_info",
    "Telemetry", "RoundCallback", "final_val_mse", "cap_bucket",
    "next_pow2", "ALGORITHMS", "BOUNDS", "BACKENDS",
]

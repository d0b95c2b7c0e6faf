"""The legacy single-call driver: a thin shim over `repro_torch.api`.

Port of `repro/core/driver.py`. `fit()` keeps the JAX package's keyword
signature and its dict-based telemetry records; new code should use
`repro_torch.api.NestedKMeans` or `repro_torch.api.fit`. Like the
estimator it runs on ``device="cuda"`` unless told otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.state import KMeansState

__all__ = ["ALGORITHMS", "FitResult", "fit"]

# a copy of repro_torch.api.config.ALGORITHMS: core sits below api and
# imports it only inside `fit`; tests/test_torch_algorithms.py holds the
# two equal
ALGORITHMS = ("lloyd", "lloyd-elkan", "mb", "sgd", "mbf", "gb", "tb")


@dataclasses.dataclass
class FitResult:
    """Legacy result record (telemetry as plain dicts)."""
    C: np.ndarray
    state: KMeansState
    telemetry: List[Dict[str, Any]]
    converged: bool
    algorithm: str

    @property
    def final_mse(self) -> float:
        for rec in reversed(self.telemetry):
            if rec.get("val_mse") is not None:
                return rec["val_mse"]
        return float("nan")

    @classmethod
    def from_outcome(cls, out, algorithm: Optional[str] = None
                     ) -> "FitResult":
        return cls(C=out.C, state=out.state,
                   telemetry=[t.to_dict() for t in out.telemetry],
                   converged=out.converged,
                   algorithm=algorithm or out.algorithm)


def fit(X,
        k: int,
        *,
        algorithm: str = "tb",
        rho: float = float("inf"),
        b0: int = 5000,
        bounds: str = "hamerly2",
        X_val=None,
        max_rounds: int = 10_000,
        time_budget_s: float = float("inf"),
        seed: int = 0,
        eval_every: int = 10,
        use_shalf: bool = True,
        kernel_backend: Optional[str] = None,
        shuffle: bool = True,
        converge_patience: int = 2,
        on_round: Optional[Callable[[Dict[str, Any]], None]] = None,
        init_C: Optional[np.ndarray] = None,
        device="cuda",
        ) -> FitResult:
    """Run one of the paper's algorithms to convergence or budget: a
    `repro_torch.api.FitConfig` built from the keywords, fitted by
    `NestedKMeans` on ``device``."""
    from repro_torch import api

    config = api.FitConfig(
        k=k, algorithm=algorithm, rho=rho, b0=b0, bounds=bounds,
        max_rounds=max_rounds, time_budget_s=time_budget_s, seed=seed,
        eval_every=eval_every, use_shalf=use_shalf,
        kernel_backend=kernel_backend, shuffle=shuffle,
        converge_patience=converge_patience)
    cb = (lambda rec: on_round(rec.to_dict())) if on_round else None
    out = api.fit(X, config, X_val=X_val, init_C=init_C, on_round=cb,
                  device=device)
    return FitResult.from_outcome(out)

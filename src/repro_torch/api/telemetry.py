"""Structured per-round telemetry replacing the ad-hoc dict records.

The engines emit one `Telemetry` record per round; callbacks receive the
record as it is appended, so a serving loop can stream progress without
polling. `to_dict()` keeps the exact key set the legacy dict records
used, so checkpoints/manifests written by older runs stay readable —
and is JSON-safe: numpy scalars are coerced to plain Python and
non-finite floats encode as ``"nan"`` / ``"inf"`` / ``"-inf"`` strings
(bare NaN in a JSON file is rejected by strict parsers), which
`from_dict` decodes back. `from_round` is the ONE way a host-landed
round becomes a record, shared by `run_loop` and `partial_fit` so the
two paths can never drift.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

_INT_FIELDS = frozenset({"round", "b", "n_changed", "n_recomputed"})
_FLOAT_FIELDS = frozenset({"t", "batch_mse", "r_median", "val_mse"})


def _enc_value(name: str, v: Any) -> Any:
    if v is None:
        return None
    if name in _INT_FIELDS:
        return int(v)
    if name in _FLOAT_FIELDS:
        f = float(v)
        if math.isnan(f):
            return "nan"
        if math.isinf(f):
            return "inf" if f > 0 else "-inf"
        return f
    return bool(v)


def _dec_value(name: str, v: Any) -> Any:
    if name in _FLOAT_FIELDS and isinstance(v, str):
        return float(v)
    return v


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """One host-loop round.

    ``t`` is cumulative *compute* wall-clock (validation eval excluded,
    matching the paper's protocol §4.3). ``val_mse`` is None on rounds
    where validation was not evaluated.
    """
    round: int                 # 0-based host-loop round index
    t: float                   # cumulative compute seconds
    b: int                     # active (global) batch size this round
    batch_mse: Optional[float]
    n_changed: int
    n_recomputed: int
    grow: bool
    r_median: Optional[float]  # controller's median sigma_C/p ratio
    val_mse: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe dict: plain-Python scalars, non-finite floats as
        ``"nan"``/``"inf"``/``"-inf"`` strings."""
        return {f.name: _enc_value(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Telemetry":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: _dec_value(k, v) for k, v in d.items()
                      if k in known})

    @classmethod
    def from_round(cls, hinfo, *, round: int, t: float,
                   val_mse: Optional[float] = None) -> "Telemetry":
        """One record from a host-landed round.

        ``hinfo`` is duck-typed (any object with the `HostRoundInfo`
        fields) so this module stays import-light; both `run_loop` and
        `NestedKMeans.partial_fit` build their records here.
        """
        return cls(round=int(round), t=float(t), b=int(hinfo.n_active),
                   batch_mse=float(hinfo.batch_mse),
                   n_changed=int(hinfo.n_changed),
                   n_recomputed=int(hinfo.n_recomputed),
                   grow=bool(hinfo.grow),
                   r_median=float(hinfo.r_median),
                   val_mse=None if val_mse is None else float(val_mse))


# callback invoked with each record as it is produced
RoundCallback = Callable[[Telemetry], None]


def final_val_mse(telemetry: List[Telemetry]) -> float:
    """Last recorded validation MSE (nan if none was ever evaluated)."""
    for rec in reversed(telemetry):
        if rec.val_mse is not None:
            return rec.val_mse
    return float("nan")

"""Arithmetic that several metric readers share (``perfbench/metrics``)."""
from __future__ import annotations

import statistics
from typing import Optional

from perfbench import yardstick


def mfu_percent(run) -> Optional[float]:
    """The window's share of the card's TF32 peak: the algorithm's own
    operations (`yardstick.model_flops` of each unit's k-scanned rows)
    over the window's seconds."""
    rows = sum(u.get("k_scan_rows", 0) for u in run.units)
    if not rows or run.window_s <= 0:
        return None
    flops = yardstick.model_flops(rows, run.config["k"], run.config["dim"])
    return 100.0 * flops / (run.window_s * yardstick.PEAK_TF32_FLOPS)


def roofline_percent(run, ops=None) -> Optional[float]:
    """Sum of the calls' bounds over the sum of their times, of the
    instrumented pass's calls of ``ops`` (all where None)."""
    calls = [c for c in run.op_calls if ops is None or c["op"] in ops]
    ms = sum(c["ms"] for c in calls)
    if not calls or ms <= 0:
        return None
    return 100.0 * sum(c["bound_ms"] for c in calls) / ms


def idle_percent(run) -> Optional[float]:
    """The profiled pass's device idle share of its window."""
    p = run.profile
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def unit_mean(run, key: str) -> Optional[float]:
    vals = [u[key] for u in run.units if key in u]
    return statistics.fmean(vals) if vals else None

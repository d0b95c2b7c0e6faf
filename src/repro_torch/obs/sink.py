"""`FitObserver` — the concrete obs sink a traced fit writes through.

Port of `repro/obs/sink.py`. `repro_torch.api.loop.ObsSink` is the
*seam*: a no-op base class `run_loop` and the engines call
unconditionally. This module is the *implementation* wired in when
``FitConfig(trace_dir=...)`` is set: every round's host-landed scalars go
to a `SpanTracer` JSONL stream, a `MetricsRegistry` aggregates counters,
gauges and histograms (written to ``metrics-p<pid>.json`` at close), and
a `WorkModel` prices each round against the H100 roofline.

The observer is **duck-typed** (it does not import `api.loop`) and
imports no torch: every value handed to `round_end` is already
host-landed plain Python (`HostRoundInfo` fields, `time.perf_counter`
floats, `StoreMetrics` dicts, `util.tracecount` marks). It never
sees a tensor, which is what keeps the host-sync auditor silent with
tracing on (`tests/test_torch_obs.py`, `tests/test_torch_analysis.py`).
"""
from __future__ import annotations

import contextlib
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional, Union

from repro_torch.obs.efficiency import WorkModel
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import OBS_SCHEMA, SpanTracer
from repro_torch.util import tracecount


def _safe(v):
    """JSON-safe scalar: non-finite floats become None (strict parsers
    reject bare NaN), everything else passes through."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


class FitObserver:
    """Observability sink for one fit (one per process).

    Satisfies the `api.loop.ObsSink` duck-type surface — ``span`` /
    ``count`` / ``round_end`` / ``fit_end`` / ``close`` — and writes:

      * ``trace-p<pid>-<seq>.jsonl``  — the span/event stream;
      * ``metrics-p<pid>.json``       — the registry export, at close.

    ``k``/``d`` enable the roofline `WorkModel`; without them the
    observer still traces rounds, just without priced work or the
    utilization gauge. ``bounds`` selects the model's work unit:
    elkan/exponion rounds count individual pair distances in
    ``n_recomputed`` (annulus scans, not full k rows), and pricing them
    as k-scans would overstate the work by exactly the pruning factor.
    """

    def __init__(self, trace_dir: Union[str, Path], *, process_id: int = 0,
                 k: Optional[int] = None, d: Optional[int] = None,
                 bounds: Optional[str] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 rotate_bytes: int = 8 << 20):
        self.tracer = SpanTracer(trace_dir, process_id=process_id,
                                 rotate_bytes=rotate_bytes)
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.work = (WorkModel.for_bounds(k, d, bounds or "hamerly2")
                     if k and d else None)
        self._closed = False
        self._tc_mark = tracecount.mark()
        self._store_before: Dict[str, Any] = {}
        r = self.registry
        self._rounds = r.counter("fit_rounds", "completed loop rounds")
        self._kscans = r.counter(
            "fit_kscans", "points that paid a full k-centroid scan")
        self._retraces = r.counter(
            "fit_jit_traces",
            "round keys first seen during the fit (util.tracecount)")
        self._round_s = r.histogram(
            "fit_round_seconds", "per-round wall time", unit="s")
        self._g_kscans = r.gauge(
            "fit_kscans_per_s", "last round's achieved k-scan rate")
        self._g_bytes = r.gauge(
            "fit_bytes_per_s", "last round's achieved HBM byte rate")
        self._g_util = r.gauge(
            "fit_roofline_utilization",
            "last round's bound_s / wall_s vs the H100 roofline model")
        self._g_b = r.gauge("fit_b_global", "current global nested batch")
        attrs = dict(meta or {})
        attrs.update(obs_schema=OBS_SCHEMA, k=k, d=d)
        self.tracer.event("fit_start", **attrs)

    # -- the ObsSink duck-type surface ---------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        t0 = time.monotonic()
        with self.tracer.span(name, **attrs):
            yield
        self.registry.histogram(f"fit_{name}_seconds",
                                f"{name} span wall time",
                                unit="s").record(time.monotonic() - t0)

    def count(self, name: str, n: int = 1) -> None:
        self.registry.counter(f"fit_{name}",
                              f"{name} occurrences").inc(n)
        self.tracer.event(name, n=n)

    def round_end(self, round: int, hinfo, *, dt_s: float, t_work: float,
                  b_global: int, capacity: Optional[int],
                  quiet_rounds: int, algorithm: str,
                  val_mse: Optional[float] = None,
                  store: Optional[Dict[str, Any]] = None) -> None:
        """Record one completed round from already-host-landed scalars."""
        attrs: Dict[str, Any] = {
            "round": int(round), "algorithm": algorithm,
            "dt_s": float(dt_s), "t_work": float(t_work),
            "b_global": int(b_global), "capacity": capacity,
            "quiet_rounds": int(quiet_rounds),
            "batch_mse": _safe(float(hinfo.batch_mse)),
            "n_changed": int(hinfo.n_changed),
            "n_active": int(hinfo.n_active),
            "grow": bool(hinfo.grow), "overflow": bool(hinfo.overflow),
            "r_median": _safe(float(hinfo.r_median)),
            "p_max": _safe(float(hinfo.p_max)),
            "kscans": int(hinfo.n_recomputed),
            "val_mse": _safe(float(val_mse)) if val_mse is not None
                       else None,
        }
        if self.work is not None:
            w = self.work.round_work(hinfo.n_recomputed, dt_s)
            attrs.update(work_unit=w.unit,
                         dist_evals=w.dist_evals, flops=w.flops,
                         bytes=int(w.hbm_bytes),
                         bound_s=_safe(w.bound_s),
                         bottleneck=w.bottleneck,
                         utilization=_safe(w.utilization))
            if dt_s > 0.0:
                self._g_kscans.set(w.kscans / dt_s)
                self._g_bytes.set(w.hbm_bytes / dt_s)
            if w.utilization is not None:
                self._g_util.set(w.utilization)
        if store:
            delta = {f"store_{key}": v - self._store_before.get(key, 0)
                     for key, v in store.items()
                     if isinstance(v, (int, float))}
            self._store_before = dict(store)
            attrs.update(delta)
        # the keys first seen since the last round; `since` costs only
        # the new keys (a diff of snapshots walked every key the process
        # had seen, a cost that grew with the process's earlier fits)
        traced = tracecount.since(self._tc_mark)
        if traced:
            self._tc_mark = tracecount.mark()
            n_traces = sum(traced.values())
            self._retraces.inc(n_traces)
            for (site, statics), n in sorted(traced.items()):
                self.tracer.event(
                    "jit_trace", site=site, n=n,
                    statics={name: v for name, v in statics})
            attrs["jit_traces"] = n_traces
        self._rounds.inc()
        self._kscans.inc(int(hinfo.n_recomputed))
        self._round_s.record(dt_s)
        self._g_b.set(float(b_global))
        self.tracer.event("round", **attrs)

    def fit_end(self, **summary) -> None:
        self.tracer.event("fit_end",
                          **{k: _safe(v) for k, v in summary.items()})
        self.tracer.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        path = (self.tracer.dir /
                f"metrics-p{self.tracer.process_id:05d}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.registry.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        self.tracer.close()

    def __enter__(self) -> "FitObserver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

"""Unified metrics: counters, gauges, log-bucket histograms, one registry.

The port's own copy of `repro/obs/metrics.py`, line for line: the port
imports nothing of the JAX package, and dashboards read the two
packages' exports alike, so ``to_dict()`` keeps its schema and
``to_prometheus()`` its text byte for byte. `LatencyHistogram` is the
registry's `Histogram` with ``unit="s"``, and `ServeMetrics` writes
through a `MetricsRegistry`:

  * ``registry.to_dict()``      — JSON-safe nested dict;
  * ``registry.to_prometheus()``— Prometheus text exposition format
    (``# TYPE`` lines, cumulative histogram buckets, ``_sum``/``_count``).

Everything here is plain Python + ``math`` — no torch, no numpy — so
importing it can never provoke a device sync.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, Optional, Tuple


class Counter:
    """Monotone counter."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) is negative")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Log-spaced histogram with percentile estimates from bucket edges.

    Buckets span ``lo`` upward at ``base``-factor spacing (defaults:
    1 µs at 1.12x — ~240 buckets to 100 s), so a percentile read is
    within one bucket factor (~12%) of the true value — fine for
    dashboards; benchmarks that assert on ratios keep their own exact
    sample arrays. ``unit`` suffixes the ``to_dict()`` keys: with the
    default ``unit="s"`` the export is byte-identical to the historical
    ``serve.metrics.LatencyHistogram`` (count / mean_s / p50_s / p99_s /
    max_s).
    """

    BASE = 1.12
    LO = 1e-6

    def __init__(self, name: str = "", help: str = "", *,
                 base: float = BASE, lo: float = LO, unit: str = "s"):
        if not (base > 1.0):
            raise ValueError(f"histogram base must be > 1, got {base}")
        if not (lo > 0.0):
            raise ValueError(f"histogram lo must be > 0, got {lo}")
        self.name = name
        self.help = help
        self.base = base
        self.lo = lo
        self.unit = unit
        self._lock = threading.Lock()
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, value: float) -> None:
        b = 0 if value <= self.lo else \
            int(math.log(value / self.lo, self.base)) + 1
        with self._lock:
            self.counts[b] = self.counts.get(b, 0) + 1
            self.n += 1
            self.total += value
            if value > self.max:
                self.max = value

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding quantile ``q`` (0..1)."""
        with self._lock:
            if not self.n:
                return float("nan")
            rank = q * (self.n - 1)
            seen = 0
            for b in sorted(self.counts):
                seen += self.counts[b]
                if seen > rank:
                    return self.lo * self.base ** b
            return self.max

    def to_dict(self) -> dict:
        u = f"_{self.unit}" if self.unit else ""
        with self._lock:
            n, total, mx = self.n, self.total, self.max
        return {
            "count": n,
            f"mean{u}": total / n if n else float("nan"),
            f"p50{u}": self.percentile(0.50),
            f"p99{u}": self.percentile(0.99),
            f"max{u}": mx,
        }

    def bucket_edges(self) -> Iterable[Tuple[float, int]]:
        """(upper_edge, count) per OCCUPIED bucket, ascending."""
        with self._lock:
            items = sorted(self.counts.items())
        for b, c in items:
            yield self.lo * self.base ** b, c


#: historical name, kept as the canonical alias for latency use.
LatencyHistogram = Histogram


_NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    out = _NAME_SANITIZE.sub("_", name)
    if not out or out[0].isdigit():
        out = "_" + out
    return out


def _prom_num(v: float) -> str:
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
    return repr(v) if isinstance(v, float) else str(v)


class MetricsRegistry:
    """Get-or-create registry of named metrics with two exporters.

    ``counter`` / ``gauge`` / ``histogram`` return the existing metric
    when the name is already registered (so instrumentation sites never
    need to coordinate creation) and raise on a type clash rather than
    silently mixing semantics under one name.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} is a {type(m).__name__}, not a "
                    f"{cls.__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter,
                                   lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, lambda: Gauge(name, help))

    def histogram(self, name: str, help: str = "", *,
                  base: float = Histogram.BASE, lo: float = Histogram.LO,
                  unit: str = "s") -> Histogram:
        return self._get_or_create(
            name, Histogram,
            lambda: Histogram(name, help, base=base, lo=lo, unit=unit))

    def metrics(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    def to_dict(self) -> dict:
        """JSON-safe export, grouped by metric kind."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self.metrics().items()):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.to_dict()
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (one scrape payload)."""
        lines = []
        for name, m in sorted(self.metrics().items()):
            pname = _prom_name(name)
            if isinstance(m, Counter):
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} counter")
                lines.append(f"{pname} {m.value}")
            elif isinstance(m, Gauge):
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} gauge")
                lines.append(f"{pname} {_prom_num(m.value)}")
            elif isinstance(m, Histogram):
                if m.help:
                    lines.append(f"# HELP {pname} {m.help}")
                lines.append(f"# TYPE {pname} histogram")
                cum = 0
                for edge, count in m.bucket_edges():
                    cum += count
                    lines.append(
                        f'{pname}_bucket{{le="{_prom_num(edge)}"}} {cum}')
                with m._lock:
                    n, total = m.n, m.total
                lines.append(f'{pname}_bucket{{le="+Inf"}} {n}')
                lines.append(f"{pname}_sum {_prom_num(float(total))}")
                lines.append(f"{pname}_count {n}")
        return "\n".join(lines) + ("\n" if lines else "")


class ServeMetrics:
    """Counters + histograms for one `ClusterService`.

    Same public surface and byte-identical ``to_dict()`` schema as the
    historical ``serve.metrics.ServeMetrics``; the storage underneath is
    a `MetricsRegistry` (pass one in to co-export serving metrics with
    the rest of a process's obs plane, e.g. over ``to_prometheus()``).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self._lock = threading.Lock()
        r = self.registry
        self._predict_requests = r.counter(
            "serve_predict_requests", "predict() calls")
        self._predict_rows = r.counter(
            "serve_predict_rows", "rows labelled by predict()")
        self._refreshes = r.counter(
            "serve_refreshes", "background refresh cycles")
        self._refresh_rows = r.counter(
            "serve_refresh_rows", "rows folded in by refreshes")
        self._escalations = r.counter(
            "serve_refresh_escalations", "drift-triggered full re-fits")
        self._ingest_calls = r.counter(
            "serve_ingest_calls", "ingest() calls")
        self.predict_latency = r.histogram(
            "serve_predict_latency", "predict() wall seconds", unit="s")
        self.refresh_latency = r.histogram(
            "serve_refresh_latency", "refresh cycle wall seconds",
            unit="s")

    # historical attribute surface (plain ints before the registry port)

    @property
    def predict_requests(self) -> int:
        return self._predict_requests.value

    @property
    def predict_rows(self) -> int:
        return self._predict_rows.value

    @property
    def refreshes(self) -> int:
        return self._refreshes.value

    @property
    def refresh_rows(self) -> int:
        return self._refresh_rows.value

    @property
    def escalations(self) -> int:
        return self._escalations.value

    @property
    def ingest_calls(self) -> int:
        return self._ingest_calls.value

    # -- recording -----------------------------------------------------------

    def observe_predict(self, seconds: float, rows: int) -> None:
        with self._lock:
            self._predict_requests.inc()
            self._predict_rows.inc(rows)
            self.predict_latency.record(seconds)

    def observe_refresh(self, seconds: float, rows: int) -> None:
        with self._lock:
            self._refreshes.inc()
            self._refresh_rows.inc(rows)
            self.refresh_latency.record(seconds)

    def observe_escalation(self) -> None:
        with self._lock:
            self._escalations.inc()

    def observe_ingest(self) -> None:
        with self._lock:
            self._ingest_calls.inc()

    # -- export --------------------------------------------------------------

    def to_dict(self, *, queue_stats: Optional[dict] = None,
                snapshot=None) -> dict:
        """JSON-safe export; pass the queue/snapshot for their gauges."""
        with self._lock:
            out = {
                "predict": {"requests": self.predict_requests,
                            "rows": self.predict_rows,
                            "latency": self.predict_latency.to_dict()},
                "refresh": {"count": self.refreshes,
                            "rows": self.refresh_rows,
                            "escalations": self.escalations,
                            "latency": self.refresh_latency.to_dict()},
                "ingest_calls": self.ingest_calls,
            }
        if queue_stats is not None:
            out["queue"] = dict(queue_stats)
        if snapshot is not None:
            out["snapshot"] = {"version": snapshot.version,
                               "age_s": snapshot.age_s(),
                               "n_rounds": snapshot.n_rounds,
                               "batch_mse": snapshot.batch_mse}
        return out

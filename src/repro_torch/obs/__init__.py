"""repro_torch.obs — structured tracing, the metrics registry and the
H100 roofline telemetry of the port (the port of `repro.obs`).

  * `SpanTracer` / `read_events` / `summarize` (``trace.py``) —
    rotating JSONL span and event logs with a merge reader and a
    ``python -m repro_torch.obs`` CLI; the JAX package's format, so
    either package reads the other's directories;
  * `MetricsRegistry` / `Counter` / `Gauge` / `Histogram`
    (``metrics.py``) with JSON and Prometheus-text exporters, and
    `ServeMetrics`;
  * `WorkModel` (``efficiency.py``) — per-round work against the bound
    of one H100 (``roofline/analysis.py``), exported as a live
    utilization gauge;
  * `span` / `observe` / `recent_roots` (``spans.py``) — the spans at
    the port's layer boundaries: always-on totals a root (the last 64
    fits and predicts, in memory), the bound sink's JSONL record, and a
    range on the `torch.profiler` timeline while one records;
  * `FitObserver` (``sink.py``) — the sink behind
    ``FitConfig(trace_dir=...)``: the spans' records and the host loop's
    `ObsSink` calls go to its trace directory.

The package imports no torch and no numpy: attaching it to the host loop
cannot make the device synchronise, and the reader CLI runs anywhere
Python does.
"""
from repro_torch.obs.efficiency import (BOUNDS_WORK_UNIT, TF32_FLOPS_PER_DIST,
                                        RoundWork, WorkModel)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     LatencyHistogram, MetricsRegistry,
                                     ServeMetrics)
from repro_torch.obs.sink import FitObserver
from repro_torch.obs.spans import Root, observe, recent_roots, span
from repro_torch.obs.trace import (OBS_SCHEMA, SpanTracer, read_events,
                                   summarize, tail_events, trace_files)

__all__ = [
    "OBS_SCHEMA", "SpanTracer", "read_events", "summarize", "tail_events",
    "trace_files",
    "Counter", "Gauge", "Histogram", "LatencyHistogram", "MetricsRegistry",
    "ServeMetrics",
    "WorkModel", "RoundWork", "BOUNDS_WORK_UNIT", "TF32_FLOPS_PER_DIST",
    "FitObserver",
    "span", "observe", "recent_roots", "Root",
]

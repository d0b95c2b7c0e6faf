"""repro_torch.obs — the metrics registry of the port.

The part of `repro.obs` that the streaming service writes through:
`MetricsRegistry` with its `Counter`, `Gauge` and `Histogram`
(`LatencyHistogram`), its JSON and Prometheus-text exporters, and
`ServeMetrics` (``metrics.py``). The rest of `repro.obs` (span tracing,
the fit observer sink, the efficiency model and the reader CLI) is not
ported yet: ROADMAP Queue 1 item 8.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     LatencyHistogram, MetricsRegistry,
                                     ServeMetrics)

__all__ = [
    "Counter", "Gauge", "Histogram", "LatencyHistogram", "MetricsRegistry",
    "ServeMetrics",
]

"""Serving metrics: a re-export of `repro_torch.obs.metrics`.

`LatencyHistogram` and `ServeMetrics` live in the shared registry module,
as in the JAX package (`repro/serve/metrics.py`); this module keeps the
import path the service and its callers use.
"""
from repro_torch.obs.metrics import LatencyHistogram, ServeMetrics

__all__ = ["LatencyHistogram", "ServeMetrics"]

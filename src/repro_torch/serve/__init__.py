"""repro_torch.serve — streaming clustering service over `repro_torch.api`.

Port of `repro/serve/`:

    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.serve import ClusterService

    svc = ClusterService(NestedKMeans(FitConfig(k=50)),
                         micro_batch=2048).start()
    svc.ingest(stream_rows)          # any size, even < k
    labels = svc.predict(X)          # lock-free, never blocked by refresh
    svc.stop()

Readers answer from immutable versioned `CodebookSnapshot`s swapped
atomically, producers feed a bounded `IngestQueue` (block / drop-oldest /
reservoir backpressure, optional per-point dedup), and one background
refresher thread drains the queue through `NestedKMeans.partial_fit` on
a CUDA stream of its own — escalating to a full checkpointed re-`fit`
when the batch-MSE trend says the codebook has drifted.
`ServeMetrics.to_dict()` exports it all.
"""
from repro_torch.serve.metrics import LatencyHistogram, ServeMetrics
from repro_torch.serve.queue import POLICIES, IngestQueue
from repro_torch.serve.service import ClusterService
from repro_torch.serve.snapshot import (CodebookSnapshot, SnapshotRef,
                                        codebook_checksum)

__all__ = [
    "ClusterService", "IngestQueue", "POLICIES",
    "CodebookSnapshot", "SnapshotRef", "codebook_checksum",
    "ServeMetrics", "LatencyHistogram",
]

"""Immutable, versioned codebook snapshots for lock-free readers.

Port of `repro/serve/snapshot.py`. A `CodebookSnapshot` is the unit of
publication in `repro_torch.serve`: the refresher thread builds a NEW
snapshot from the estimator's `export_codebook()` and swaps it into a
single reference (`SnapshotRef.publish`). Reader threads load that
reference once per request — a plain attribute read, atomic under the
interpreter — and then work exclusively on the immutable snapshot they
got. There is no reader lock, and a reader can never observe a
half-updated codebook: either it sees the old snapshot or the new one,
both internally consistent (the `checksum` field lets tests and paranoid
callers verify exactly that).

Where the JAX package keeps module-level jitted closures, `predict` here
calls `ops.assign_top2` under a plan from `resolve_plan` (the
``assign_top2`` kernel for a snapshot on a CUDA device, with no fallback
to the plain version; the plain version on the CPU or under
``kernel_backend="ref"``), and `transform` calls `ref.pairwise_dist2`.

Device memory: a snapshot holds its codebook on the host only. Each call
uploads C (157 KB at k = 50, d = 784) together with the request's rows,
on the calling thread's current stream, and copies the answer back on
that stream before it returns, as the JAX package's
``jnp.asarray(self.centroids)`` does on every call. Every device tensor
of a call is then allocated, used and freed on one stream, so the
caching allocator can never hand a block to the refresher's stream while
a reader's kernel still reads it. A device copy of C cached per
snapshot would save that upload, but it would be allocated on the
refresher's stream and read on the readers': it would need an event that
the refresher waits on before it publishes and a ``record_stream`` by
every reader, for a copy that is small beside the request's own rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels._build import resolve_device
from repro_torch.kernels.plan import resolve_plan


def codebook_checksum(centroids: np.ndarray, counts: np.ndarray,
                      version: int) -> float:
    """Order-independent fingerprint binding (version, C, v) together.

    float64 sums are cheap, deterministic for a fixed array, and any
    torn mix of two snapshots' buffers changes the value with
    overwhelming probability (the version term keeps two refreshes that
    happen to share centroids distinguishable).
    """
    return float(np.sum(centroids, dtype=np.float64)
                 + 0.5 * np.sum(counts, dtype=np.float64)
                 + 1e-3 * version)


@dataclasses.dataclass(frozen=True)
class CodebookSnapshot:
    """One published codebook: centroids + counts + inference calls.

    ``version`` is assigned by the publisher and strictly increases;
    ``created_at`` is a `time.monotonic` stamp (age, not wall time).
    Arrays are read-only numpy views — mutating them raises. ``device``
    is where `predict` and `transform` run.
    """
    version: int
    centroids: np.ndarray        # (k, d) float32, read-only
    counts: np.ndarray           # (k,)  float32, read-only
    n_rounds: int                # estimator rounds folded in so far
    batch_mse: float             # last refresh's batch MSE
    created_at: float            # time.monotonic at publication
    checksum: float              # codebook_checksum(C, v, version)
    kernel_backend: Optional[str] = None
    device: torch.device = torch.device("cuda")
    # C as a host tensor over the same memory (torch reads no read-only
    # numpy array); never written
    _C: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def create(cls, version: int, exported: dict, *,
               kernel_backend: Optional[str] = None,
               device="cuda") -> "CodebookSnapshot":
        """Build from `NestedKMeans.export_codebook()` output, to serve on
        ``device`` (the estimator's)."""
        device = resolve_device(device)
        C = np.array(exported["centroids"], dtype=np.float32, order="C")
        v = np.array(exported["counts"], dtype=np.float32, order="C")
        C_host = torch.from_numpy(C)
        C.setflags(write=False)
        v.setflags(write=False)
        return cls(version=version, centroids=C, counts=v,
                   n_rounds=int(exported["n_rounds"]),
                   batch_mse=float(exported["batch_mse"]),
                   created_at=time.monotonic(),
                   checksum=codebook_checksum(C, v, version),
                   kernel_backend=kernel_backend, device=device, _C=C_host)

    # -- shape ---------------------------------------------------------------

    @property
    def k(self) -> int:
        return self.centroids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    def age_s(self) -> float:
        return time.monotonic() - self.created_at

    def verify(self) -> bool:
        """Recompute the checksum — False would mean a torn read."""
        return self.checksum == codebook_checksum(
            self.centroids, self.counts, self.version)

    # -- inference (pure reads, safe from any thread) ------------------------

    def _on_device(self):
        """The snapshot's CUDA device as the calling thread's current one
        (a new thread starts on device 0)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _operands(self, X):
        Xd = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32))
        return Xd.to(self.device), self._C.to(self.device)

    def _assign(self, X):
        with self._on_device():
            Xd, Cd = self._operands(X)
            plan = resolve_plan(self.kernel_backend, b=Xd.shape[0],
                                k=self.k, d=self.dim, device=self.device)
            a, d1, _ = ops.assign_top2(Xd, Cd, plan=plan)
            return a.cpu().numpy(), d1.cpu().numpy()

    def predict(self, X) -> np.ndarray:
        """Nearest-centroid index (int32) for each row of ``X``."""
        return self._assign(X)[0]

    def predict_with_distance(self, X):
        """(labels, euclidean distance to the assigned centroid)."""
        a, d1 = self._assign(X)
        return a, np.sqrt(np.maximum(d1, 0.0))

    def transform(self, X) -> np.ndarray:
        """Euclidean distance of each row to every centroid: (n, k)."""
        with self._on_device():
            Xd, Cd = self._operands(X)
            d2 = ref.pairwise_dist2(Xd, Cd)
            return torch.sqrt(torch.clamp_min(d2, 0.0)).cpu().numpy()


class SnapshotRef:
    """The single mutable cell readers poll: atomic swap, monotone version.

    `publish` is called by ONE writer (the refresher); `load` by any
    number of readers. The version check on publish turns an accidental
    second writer into a loud error instead of a silently regressing
    snapshot stream.
    """

    def __init__(self):
        self._snap: Optional[CodebookSnapshot] = None

    def load(self) -> Optional[CodebookSnapshot]:
        return self._snap

    def publish(self, snap: CodebookSnapshot) -> None:
        cur = self._snap
        if cur is not None and snap.version <= cur.version:
            raise ValueError(
                f"snapshot version must be monotone: {snap.version} after "
                f"{cur.version} (two writers?)")
        self._snap = snap   # atomic reference swap

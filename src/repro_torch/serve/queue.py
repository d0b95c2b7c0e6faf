"""Bounded ingest buffer between producers and the codebook refresher.

The port's own copy of `repro/serve/queue.py` (numpy and threading only;
the port imports nothing of the JAX package), with the same policies,
dedup and counters.

Producers hand in arbitrarily small row batches (`put`); the refresher
drains micro-batches (`get_batch`) of one shape. This is where the
estimator's "first `partial_fit` batch must have >= k rows" constraint
is lifted out of callers: the queue simply accumulates sub-k
contributions until the refresher's ``min_rows`` is reachable.

Backpressure policies when the buffer is full:
  block        `put` waits (optionally up to ``timeout``) for space —
               lossless, producers feel the pressure.
  drop-oldest  evict the oldest buffered rows to make room — bounded
               staleness, newest data always gets in.
  reservoir    uniform reservoir sample over every row EVER offered —
               the buffer converges to an unbiased sample of the stream.

Dedup: with ``dedup=True`` each `put` may carry per-row ids; a row whose
id was already accepted is dropped. This preserves the paper's nested
invariant — each sample contributes to the S/v statistics exactly once —
across at-least-once delivery from upstream producers.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Optional, Sequence, Tuple

import numpy as np

POLICIES = ("block", "drop-oldest", "reservoir")


class IngestQueue:
    """Thread-safe bounded row buffer with pluggable backpressure.

    Rows are stored per point (id, row) so every policy — eviction,
    reservoir replacement, dedup — operates on single samples, matching
    the "one sample = one contribution" accounting of the nested
    algorithm.
    """

    def __init__(self, *, max_rows: int = 65536, policy: str = "block",
                 dedup: bool = False, seen_cap: int = 1 << 20,
                 seed: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of "
                             f"{POLICIES}")
        if max_rows < 1:
            raise ValueError(f"max_rows must be >= 1, got {max_rows}")
        self.max_rows = max_rows
        self.policy = policy
        self.dedup = dedup
        self._seen: "OrderedDict[object, None]" = OrderedDict()
        self._seen_cap = seen_cap
        self._rng = np.random.default_rng(seed)
        self._buf: deque = deque()      # of (id_or_None, (d,) float32 row)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False
        # counters (read via stats())
        self._offered = 0
        self._accepted = 0
        self._dropped_full = 0      # rejected: buffer full (block timeout)
        self._evicted = 0           # drop-oldest / reservoir replacement
        self._deduped = 0
        self._drained = 0
        self._peak_depth = 0        # high-water mark (obs manifests)

    # -- producer side -------------------------------------------------------

    def put(self, X, ids: Optional[Sequence] = None,
            timeout: Optional[float] = None) -> int:
        """Offer rows; returns how many were ACCEPTED into the buffer.

        ``ids`` (optional, required for dedup to bite) must be one
        hashable id per row. Under ``policy="block"`` a full buffer
        waits up to ``timeout`` seconds (forever if None) for space;
        rows that still don't fit are rejected and counted.
        """
        X = np.asarray(X, dtype=np.float32)
        if X.ndim == 1:
            X = X[None, :]
        if ids is not None and len(ids) != X.shape[0]:
            raise ValueError(f"{len(ids)} ids for {X.shape[0]} rows")
        accepted = 0
        with self._lock:
            if self._closed:
                raise RuntimeError("put() on a closed IngestQueue")
            for i in range(X.shape[0]):
                self._offered += 1
                pid = ids[i] if ids is not None else None
                if self.dedup and pid is not None and pid in self._seen:
                    self._deduped += 1
                    continue
                if not self._make_room(timeout):
                    self._dropped_full += 1
                    continue
                # ids are remembered only once the row is actually
                # accepted, so a rejected row may be redelivered later
                # without tripping the dedup
                if self.dedup and pid is not None:
                    self._remember(pid)
                self._buf.append((pid, X[i]))
                self._accepted += 1
                accepted += 1
            if len(self._buf) > self._peak_depth:
                self._peak_depth = len(self._buf)
            if accepted:
                self._not_empty.notify_all()
        return accepted

    def _remember(self, pid) -> None:
        self._seen[pid] = None
        if len(self._seen) > self._seen_cap:
            self._seen.popitem(last=False)

    def _evict(self, idx: int) -> None:
        """Drop a buffered row; forget its id so that an evicted sample
        can be REdelivered — it never reached the statistics, and 'each
        sample contributes exactly once' must not decay to 'zero times'.
        Lock held."""
        pid, _ = self._buf[idx]
        del self._buf[idx]
        if pid is not None:
            self._seen.pop(pid, None)
        self._evicted += 1

    def _make_room(self, timeout: Optional[float]) -> bool:
        """Ensure space for one row per the policy. Lock held."""
        if len(self._buf) < self.max_rows:
            return True
        if self.policy == "drop-oldest":
            self._evict(0)
            return True
        if self.policy == "reservoir":
            # classic reservoir over the _offered stream: keep the new
            # row with probability max_rows / offered, replacing a
            # uniformly random resident; otherwise drop it.
            j = int(self._rng.integers(0, self._offered))
            if j < self.max_rows:
                self._evict(j)
                return True
            return False
        # block
        ok = self._not_full.wait_for(
            lambda: self._closed or len(self._buf) < self.max_rows,
            timeout=timeout)
        if self._closed:
            # fail the BLOCKED producer loudly too — returning 0 here
            # would silently drop every batch after a refresher death
            raise RuntimeError(
                "IngestQueue closed while a producer was blocked on it")
        return bool(ok) and len(self._buf) < self.max_rows

    # -- consumer side -------------------------------------------------------

    def get_batch(self, max_rows: int, *, min_rows: int = 1,
                  timeout: Optional[float] = None, allow_short: bool = True
                  ) -> Optional[Tuple[np.ndarray, list]]:
        """Drain up to ``max_rows`` rows once >= ``min_rows`` are buffered.

        Waits up to ``timeout`` for ``min_rows``; on timeout returns
        whatever is buffered (possibly fewer than ``min_rows`` — a
        flush), or None if the buffer is empty. With
        ``allow_short=False`` a sub-``min_rows`` buffer is left in place
        and None is returned instead (used for the first refresh, which
        must see >= k rows). A closed queue drains whatever remains
        regardless of ``min_rows`` (unless ``allow_short=False``), then
        returns None. Result is ``(rows (n, d) float32, ids list)``.
        """
        with self._lock:
            self._not_empty.wait_for(
                lambda: self._closed or len(self._buf) >= min_rows,
                timeout=timeout)
            if not self._buf:
                return None
            if not allow_short and len(self._buf) < min_rows:
                return None
            n = min(max_rows, len(self._buf))
            items = [self._buf.popleft() for _ in range(n)]
            self._drained += n
            self._not_full.notify_all()
        ids = [pid for pid, _ in items]
        return np.stack([row for _, row in items]), ids

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._buf)

    @property
    def peak_depth(self) -> int:
        """Deepest the buffer has ever been. Deliberately NOT part of
        `stats()`: the stats dict is embedded verbatim in the serving
        JSON exports, whose schema stays byte-compatible; obs manifests
        read the high-water mark from here instead."""
        with self._lock:
            return self._peak_depth

    def close(self) -> None:
        """Reject future puts; wake every waiter. Buffered rows remain
        drainable."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> dict:
        with self._lock:
            return {
                "policy": self.policy, "max_rows": self.max_rows,
                "depth": len(self._buf), "offered": self._offered,
                "accepted": self._accepted,
                "dropped_full": self._dropped_full,
                "evicted": self._evicted, "deduped": self._deduped,
                "drained": self._drained,
            }

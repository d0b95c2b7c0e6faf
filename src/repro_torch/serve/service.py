"""`ClusterService`: non-blocking streaming clustering over `partial_fit`.

Port of `repro/serve/service.py`. Threading model — exactly one writer,
lock-free readers:

  producers ──put──▶ IngestQueue ──get_batch──▶ refresher thread
                                                    │ partial_fit
                                                    ▼
         predict()/transform() ◀──atomic load── SnapshotRef.publish

The refresher drains micro-batches through the estimator's (thread-safe)
`partial_fit` and publishes a fresh immutable `CodebookSnapshot` after
every refresh. `predict` loads the current snapshot once and never takes
a lock, so codebook refreshes — even a full escalated re-`fit` — never
stall serving traffic; readers just keep answering from the previous
snapshot until the next one is swapped in.

On a CUDA device the service owns one `torch.cuda.Stream` on the
estimator's device, and every writer's device work runs on it: the
refresher's `partial_fit` calls, the snapshot exports, an escalated
`fit`, and the tail that `stop(drain=True)` folds in on the caller's
thread. Readers launch on their own thread's current stream (PyTorch's
default stream unless they choose one), which the service's stream does
not wait for, so a reader's `predict` never queues behind a refresh's
kernels. The service's threads enter the estimator's device (a new
thread starts on device 0), and the kernels are built and bound on the
constructing thread before any other thread can launch them.

Staleness / drift guardrails (Schwartzman, arXiv:2304.00419 motivates
watching the mini-batch objective trend): the service tracks the
batch-MSE of recent refreshes against the best level it has seen. When
the trend exceeds ``drift_factor`` for ``drift_window`` consecutive
refreshes, the codebook has drifted away from the stream and incremental
updates are no longer trusted: the service escalates to a full
(checkpointed, killable+resumable) `fit` over its retained history
reservoir — still on the refresher thread, with predict traffic served
from the last snapshot throughout.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.estimator import NestedKMeans, NotFittedError
from repro_torch.kernels import ops
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import IngestQueue
from repro_torch.serve.snapshot import CodebookSnapshot, SnapshotRef


class ClusterService:
    """Serve `predict` while a background refresher folds the stream in.

    Args:
      estimator    a `NestedKMeans`; may be unfitted — the first refresh
                   happens once the queue has accumulated >= k rows (the
                   queue lifts the first-batch >= k constraint out of
                   producers, who may ingest any number of rows at a
                   time). The service serves on the estimator's device;
                   on a CUDA device it runs the kernels and never the
                   plain versions (unless ``kernel_backend="ref"``).
      queue        optional pre-built `IngestQueue` (policy, bounds).
      micro_batch  refresh batch size the refresher aims for; steady
                   traffic drains in exactly this shape.
      flush_after_s  max time a sub-``micro_batch`` remainder may wait
                   before being flushed through a short refresh.
      drift_window / drift_factor   escalation trigger (see module doc).
      history_rows reservoir of past ingested rows retained for
                   escalation; 0 disables drift escalation.
    """

    def __init__(self, estimator: NestedKMeans, *,
                 queue: Optional[IngestQueue] = None,
                 micro_batch: int = 4096,
                 flush_after_s: float = 0.25,
                 drift_window: int = 8,
                 drift_factor: float = 2.0,
                 history_rows: int = 0,
                 seed: int = 0,
                 metrics: Optional[ServeMetrics] = None):
        if micro_batch < 1:
            raise ValueError(f"micro_batch must be >= 1, got {micro_batch}")
        self._km = estimator
        self.queue = queue or IngestQueue(
            max_rows=max(4 * micro_batch, estimator.config.k), seed=seed)
        self.metrics = metrics or ServeMetrics()
        self.micro_batch = micro_batch
        self.flush_after_s = flush_after_s
        self.drift_window = drift_window
        self.drift_factor = drift_factor
        self._ref = SnapshotRef()
        self._version = 0
        # serialises publishers: the refresher vs a user-thread
        # escalate(); readers never touch this lock
        self._pub_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        # drift state
        self._mse_best: Optional[float] = None
        self._mse_bad_streak = 0
        # escalation history reservoir
        self._history_rows = history_rows
        self._history: list = []
        self._history_seen = 0
        self._rng = np.random.default_rng(seed)
        # the writers' stream on the estimator's device (None on the CPU)
        self.stream: Optional[torch.cuda.Stream] = None
        if estimator.device.type == "cuda":
            ops.bind_kernels()
            self.stream = torch.cuda.Stream(device=estimator.device)
            # the codebook may still be in flight on the constructing
            # thread's stream (a fit's last ops, an adopt's upload)
            self.stream.wait_stream(
                torch.cuda.current_stream(estimator.device))

        try:
            self._publish()              # estimator already fitted
        except NotFittedError:
            # only an UNFITTED estimator ever needs a first >= k batch;
            # a fitted one streams any size from the start
            if estimator.config.k > self.queue.max_rows:
                raise ValueError(
                    f"queue max_rows={self.queue.max_rows} can never "
                    f"accumulate the >= k={estimator.config.k} rows "
                    f"the first refresh needs") from None

    def _writing(self):
        """The writers' device and stream, entered around every writer's
        device work (on any thread)."""
        if self.stream is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(self._km.device))
        ctx.enter_context(torch.cuda.stream(self.stream))
        return ctx

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ClusterService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._thread = threading.Thread(target=self._refresh_loop,
                                        name="codebook-refresher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        """Stop ingesting, halt the refresher; optionally flush the tail.

        ``drain=True`` folds whatever the queue still holds through one
        last refresh (skipped if the codebook never initialised and the
        remainder is < k rows, or if the refresher died — diagnosing
        the death beats refreshing through possibly poisoned input).
        """
        self.queue.close()
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            raise RuntimeError(
                "codebook refresher died") from self._last_error
        if drain:
            self._drain_remainder()

    def __enter__(self) -> "ClusterService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc == (None, None, None))

    # -- producer / reader API ----------------------------------------------

    def ingest(self, X, ids: Optional[Sequence] = None,
               timeout: Optional[float] = None) -> int:
        """Offer rows to the refresher; returns rows accepted."""
        self.metrics.observe_ingest()
        return self.queue.put(X, ids=ids, timeout=timeout)

    @property
    def snapshot(self) -> Optional[CodebookSnapshot]:
        """The current published snapshot (None before first refresh)."""
        return self._ref.load()

    def _require_snapshot(self) -> CodebookSnapshot:
        snap = self._ref.load()
        if snap is None:
            raise NotFittedError(
                "no codebook snapshot published yet — ingest >= k rows "
                "(or construct the service over a fitted estimator)")
        return snap

    def predict(self, X) -> np.ndarray:
        """Nearest-cell ids from the current snapshot. Never blocks on a
        refresh."""
        snap = self._require_snapshot()
        t0 = time.perf_counter()
        out = snap.predict(X)
        self.metrics.observe_predict(time.perf_counter() - t0,
                                     int(out.shape[0]))
        return out

    def transform(self, X) -> np.ndarray:
        snap = self._require_snapshot()
        t0 = time.perf_counter()
        out = snap.transform(X)
        self.metrics.observe_predict(time.perf_counter() - t0,
                                     int(out.shape[0]))
        return out

    def staleness_s(self) -> float:
        """Age of the snapshot readers are currently being served."""
        return self._require_snapshot().age_s()

    def export_metrics(self) -> dict:
        """JSON-safe metrics incl. queue depth + snapshot gauges."""
        return self.metrics.to_dict(queue_stats=self.queue.stats(),
                                    snapshot=self._ref.load())

    # -- the refresher -------------------------------------------------------

    def _fitted(self) -> bool:
        return self._ref.load() is not None

    def _refresh_loop(self) -> None:
        k = self._km.config.k
        while not self._stop.is_set():
            try:
                if not self._fitted():
                    # first refresh: must see >= k rows in one batch —
                    # sub-k contributions keep accumulating until then
                    batch = self.queue.get_batch(
                        max(self.micro_batch, k), min_rows=k,
                        timeout=self.flush_after_s, allow_short=False)
                else:
                    batch = self.queue.get_batch(
                        self.micro_batch, min_rows=self.micro_batch,
                        timeout=self.flush_after_s)
                if batch is None:
                    continue
                self._refresh(batch[0])
            except BaseException as e:     # noqa: BLE001 — keep serving
                self._last_error = e
                # wake + fail blocked producers loudly instead of
                # letting them wait on a refresher that no longer exists
                self.queue.close()
                return

    def _refresh(self, rows: np.ndarray) -> None:
        t0 = time.perf_counter()
        self._remember(rows)
        with self._writing():
            self._km.partial_fit(rows)
            self._publish()
        self.metrics.observe_refresh(time.perf_counter() - t0,
                                     int(rows.shape[0]))
        self._check_drift()

    def _publish(self) -> None:
        with self._pub_lock, self._writing():
            exported = self._km.export_codebook()
            self._version += 1
            self._ref.publish(CodebookSnapshot.create(
                self._version, exported,
                kernel_backend=self._km.config.kernel_backend,
                device=self._km.device))

    def _drain_remainder(self) -> None:
        k = self._km.config.k
        while True:
            if not self._fitted():
                # the first batch must carry >= k rows in one piece;
                # allow_short=False leaves a sub-k tail buffered
                # instead of popping rows only to abandon them
                batch = self.queue.get_batch(
                    max(self.micro_batch, k), min_rows=k, timeout=0,
                    allow_short=False)
            else:
                batch = self.queue.get_batch(self.micro_batch, timeout=0)
            if batch is None:
                return
            self._refresh(batch[0])

    # -- drift / escalation --------------------------------------------------

    def _remember(self, rows: np.ndarray) -> None:
        """Reservoir-sample drained rows for a later escalated refit."""
        if not self._history_rows:
            return
        for r in rows:
            self._history_seen += 1
            if len(self._history) < self._history_rows:
                self._history.append(r)
            else:
                j = int(self._rng.integers(0, self._history_seen))
                if j < self._history_rows:
                    self._history[j] = r

    def _check_drift(self) -> None:
        mse = self._km.telemetry_[-1].batch_mse
        if mse is None or not np.isfinite(mse):
            return
        if self._mse_best is None or mse < self._mse_best:
            self._mse_best = mse
            self._mse_bad_streak = 0
            return
        if mse > self.drift_factor * self._mse_best:
            self._mse_bad_streak += 1
        else:
            self._mse_bad_streak = 0
        if (self._history_rows and
                self._mse_bad_streak >= self.drift_window):
            self.escalate()

    def escalate(self, *, resume: bool = False) -> None:
        """Full re-`fit` over the history reservoir, on the CALLING
        thread (the refresher, for automatic drift escalation), on the
        service's stream.

        Readers keep answering from the last snapshot for the whole fit.
        With ``estimator.config.checkpoint`` set the refit checkpoints
        in-loop, so a killed escalation is itself resumable —
        ``resume=True`` continues such an interrupted refit instead of
        restarting it.
        """
        if not self._history:
            raise RuntimeError(
                "escalation needs history_rows > 0 (no retained data)")
        X = np.stack(self._history)
        self.metrics.observe_escalation()
        with self._writing():
            self._km.fit(X, resume=resume and
                         self._km.config.checkpoint is not None)
            self._publish()
        self._mse_best = None
        self._mse_bad_streak = 0

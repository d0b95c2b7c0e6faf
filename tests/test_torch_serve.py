"""The port's streaming service against the JAX package's, on the CPU.

`repro_torch.serve` (queue, snapshots, `ClusterService`),
`repro_torch.obs.metrics` and the estimator's `adopt`, `export_codebook`
and `stats_`: the cases of tests/test_serve.py and the metrics cases of
tests/test_obs.py run against the port (``device="cpu"``, the plain
versions), and the two packages are held to each other from one
codebook: the JAX estimator's fit, adopted by both (the port through
`convert.outcome_from_numpy`). Tolerances: centroids, distances and
batch MSEs at rtol=atol=1e-5, as tests/test_torch_fit.py holds fits;
counts, labels, checksums, schedules and metric exports exactly.

Every thread here is bounded: each join takes a timeout and asserts the
thread ended, each wait has a deadline and fails when it passes, and the
windows that hammer the service last at most 1 s.
"""
import dataclasses
import json
import re
import threading
import time

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.api import FitConfig as JConfig
from repro.api import NestedKMeans as JKMeans
from repro.data.synthetic import gaussian_blobs
from repro.obs import metrics as jmetrics
from repro.serve import ClusterService as JService
from repro.serve import CodebookSnapshot as JSnapshot
from repro.serve import IngestQueue as JQueue
from repro_torch.api import (CheckpointConfig, FitConfig, NestedKMeans,
                             NotFittedError)
from repro_torch.checkpoint import CheckpointStore
from repro_torch.convert import outcome_from_numpy
from repro_torch.core.state import ClusterStats
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import (Histogram, LatencyHistogram, MetricsRegistry,
                             ServeMetrics)
from repro_torch.serve import (POLICIES, ClusterService, CodebookSnapshot,
                               IngestQueue, SnapshotRef)

CPU = "cpu"
DEADLINE = 20.0
TOL = dict(rtol=1e-5, atol=1e-5)


def wait_until(pred, timeout=DEADLINE, dt=0.005):
    """True once ``pred()`` holds; False if it still fails at the
    deadline (callers assert the result)."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(dt)
    return pred()


def join_all(threads, timeout=DEADLINE):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread did not end"


def start_thread(target, *args):
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    return t


# -- IngestQueue ------------------------------------------------------------

def rows(n, d=4, base=0.0):
    return (np.arange(n * d, dtype=np.float32).reshape(n, d) + base)


def test_queue_accumulates_and_drains_fifo():
    q = IngestQueue(max_rows=100)
    assert q.put(rows(3)) == 3
    assert q.put(rows(2, base=100.0)) == 2
    X, ids = q.get_batch(10)
    assert X.shape == (5, 4) and ids == [None] * 5
    np.testing.assert_array_equal(X[:3], rows(3))
    assert q.depth == 0


def test_queue_block_policy_times_out_and_counts_rejects():
    q = IngestQueue(max_rows=4, policy="block")
    assert q.put(rows(4)) == 4
    t0 = time.time()
    assert q.put(rows(2), timeout=0.05) == 0       # full: rejected
    assert time.time() - t0 >= 0.04
    s = q.stats()
    assert s["dropped_full"] == 2 and s["accepted"] == 4

    def unblock():
        time.sleep(0.05)
        q.get_batch(2)
    t = start_thread(unblock)
    assert q.put(rows(1), timeout=5.0) == 1
    join_all([t])


def test_queue_drop_oldest_policy():
    q = IngestQueue(max_rows=4, policy="drop-oldest")
    q.put(rows(4))
    assert q.put(rows(2, base=100.0)) == 2
    X, _ = q.get_batch(10)
    assert X.shape == (4, 4)
    np.testing.assert_array_equal(X[-2:], rows(2, base=100.0))
    assert q.stats()["evicted"] == 2


def test_queue_reservoir_policy_is_bounded_sample():
    q = IngestQueue(max_rows=32, policy="reservoir", seed=0)
    for i in range(100):
        q.put(rows(8, base=float(i * 1000)))
    assert q.depth == 32
    s = q.stats()
    assert s["offered"] == 800
    assert s["evicted"] + s["dropped_full"] == 800 - 32
    X, _ = q.get_batch(100)
    assert X.shape[0] == 32
    assert (X[:, 0] < 400 * 1000).any()


@pytest.mark.parametrize("redeliver", ["after_drain", "after_reject"])
def test_queue_dedup(redeliver):
    """Each accepted id contributes once, also after its row was drained;
    an id is only 'seen' once its row is ACCEPTED, so a row bounced by
    backpressure can be retried."""
    if redeliver == "after_drain":
        q = IngestQueue(max_rows=100, dedup=True)
        assert q.put(rows(3), ids=["a", "b", "c"]) == 3
        assert q.put(rows(3), ids=["b", "c", "d"]) == 1
        assert q.stats()["deduped"] == 2
        _, ids = q.get_batch(10)
        assert ids == ["a", "b", "c", "d"]
        assert q.put(rows(1), ids=["a"]) == 0
    else:
        q = IngestQueue(max_rows=2, policy="block", dedup=True)
        assert q.put(rows(2), ids=["a", "b"]) == 2
        assert q.put(rows(1, base=50.0), ids=["c"], timeout=0.02) == 0
        q.get_batch(2)
        assert q.put(rows(1, base=50.0), ids=["c"]) == 1
        assert q.stats()["deduped"] == 0


def test_queue_dedup_forgets_evicted_ids():
    """An evicted row never reached the statistics, so its id may be
    delivered again (redelivery after eviction)."""
    q = IngestQueue(max_rows=2, policy="drop-oldest", dedup=True)
    q.put(rows(2), ids=["a", "b"])
    q.put(rows(1, base=9.0), ids=["c"])          # evicts "a"
    assert q.put(rows(1), ids=["a"]) == 1        # "a" may come back
    assert q.put(rows(1), ids=["c"]) == 0        # "c" is still buffered


def test_queue_blocked_put_raises_on_close():
    q = IngestQueue(max_rows=1, policy="block")
    q.put(rows(1))
    timer = threading.Timer(0.05, q.close)
    timer.start()
    with pytest.raises(RuntimeError):
        q.put(rows(1), timeout=10.0)
    join_all([timer])


def test_queue_get_batch_allow_short_false_waits_for_min():
    q = IngestQueue(max_rows=100)
    q.put(rows(3))
    assert q.get_batch(10, min_rows=5, timeout=0.05,
                       allow_short=False) is None
    assert q.depth == 3
    got = q.get_batch(10, min_rows=5, timeout=0.05)
    assert got is not None and got[0].shape[0] == 3


def test_queue_close_wakes_and_drains():
    q = IngestQueue(max_rows=100)
    q.put(rows(2))
    q.close()
    with pytest.raises(RuntimeError):
        q.put(rows(1))
    assert q.get_batch(10, min_rows=50, timeout=5.0)[0].shape[0] == 2
    assert q.get_batch(10, timeout=0.01) is None


def test_queue_peak_depth_is_not_in_stats():
    q = IngestQueue(max_rows=100)
    q.put(rows(7))
    q.get_batch(5)
    assert q.peak_depth == 7 and q.depth == 2
    assert "peak_depth" not in q.stats()


@pytest.mark.parametrize("policy", POLICIES)
def test_queue_matches_jax(policy):
    """The same puts, ids and drains through both queues (one seed):
    the same rows come out in the same order, with the same counters."""
    rng = np.random.default_rng(3)
    qs = [Q(max_rows=24, policy=policy, dedup=True, seed=5)
          for Q in (JQueue, IngestQueue)]
    outs = [[], []]
    for step in range(40):
        n = int(rng.integers(1, 9))
        X = rng.normal(size=(n, 3)).astype(np.float32)
        ids = [int(i) for i in rng.integers(0, 150, n)]
        for q, out in zip(qs, outs):
            out.append(q.put(X, ids=ids, timeout=0))
            if step % 3 == 2:
                out.append(q.get_batch(10))
    for a, b in zip(*outs):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
        else:
            assert a == b
    assert qs[0].stats() == qs[1].stats()
    assert qs[0].peak_depth == qs[1].peak_depth


# -- snapshots --------------------------------------------------------------

def _exported(k=4, d=3, n_rounds=1):
    rng = np.random.default_rng(k * d)
    return {"centroids": rng.normal(size=(k, d)).astype(np.float32),
            "counts": rng.integers(1, 9, k).astype(np.float32),
            "n_rounds": n_rounds, "batch_mse": 0.5}


def test_snapshot_immutable_and_checksummed():
    snap = CodebookSnapshot.create(1, _exported(), device=CPU)
    assert snap.verify()
    with pytest.raises(ValueError):
        snap.centroids[0, 0] = 9.0      # read-only
    a = snap.predict(np.zeros((2, 3), np.float32))
    assert a.shape == (2,) and a.dtype == np.int32
    assert snap.transform(np.zeros((2, 3), np.float32)).shape == (2, 4)
    assert (snap.k, snap.dim) == (4, 3)


def test_snapshot_ref_rejects_version_regression():
    ref = SnapshotRef()
    ref.publish(CodebookSnapshot.create(3, _exported(), device=CPU))
    with pytest.raises(ValueError):
        ref.publish(CodebookSnapshot.create(3, _exported(), device=CPU))
    assert ref.load().version == 3


def test_snapshot_on_cuda_needs_a_card(monkeypatch):
    """A snapshot serves on its estimator's device and never falls back
    to the CPU: "cuda" without a card raises, and kernel_backend="cuda"
    on the CPU is refused."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        CodebookSnapshot.create(1, _exported())
    snap = CodebookSnapshot.create(1, _exported(), kernel_backend="cuda",
                                   device=CPU)
    with pytest.raises(ValueError, match="CUDA device"):
        snap.predict(np.zeros((2, 3), np.float32))


def test_snapshot_matches_jax():
    """From one exported dict: the same checksum bits, the same labels,
    distances and transform within 1e-5."""
    exp = _exported(k=16, d=8, n_rounds=7)
    X = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
    j = JSnapshot.create(5, exp, kernel_backend="ref")
    t = CodebookSnapshot.create(5, exp, device=CPU)
    assert t.checksum == j.checksum and t.verify()
    assert (t.n_rounds, t.batch_mse) == (j.n_rounds, j.batch_mse)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    (ta, td), (ja, jd) = t.predict_with_distance(X), \
        j.predict_with_distance(X)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(td, jd, **TOL)
    np.testing.assert_allclose(t.transform(X), j.transform(X), **TOL)


# -- the estimator: adopt / export_codebook / stats_ -------------------------

@pytest.fixture(scope="module")
def stream_blobs():
    X, _ = gaussian_blobs(6000, k=8, dim=8, spread=5.0, seed=0)
    return X


@pytest.fixture(scope="module")
def jax_fit(blobs):
    """The JAX estimator's fit of the blobs: the one codebook both
    packages adopt."""
    X, _ = blobs
    return JKMeans(JConfig(k=8, b0=1000, kernel_backend="ref")).fit(
        X).outcome_


def _both(outcome, **kw):
    j = JKMeans(JConfig(k=8, b0=1000, kernel_backend="ref", **kw)).adopt(
        outcome)
    t = NestedKMeans(FitConfig(k=8, b0=1000, **kw), device=CPU).adopt(
        outcome_from_numpy(outcome, device=CPU))
    return j, t


def test_outcome_from_numpy_carries_the_fit(jax_fit):
    out = outcome_from_numpy(jax_fit, device=CPU)
    np.testing.assert_array_equal(out.C, np.asarray(jax_fit.C))
    np.testing.assert_array_equal(out.state.stats.C.numpy(),
                                  np.asarray(jax_fit.state.stats.C))
    np.testing.assert_array_equal(out.labels, jax_fit.labels)
    assert [r.to_dict() for r in out.telemetry] == \
        [r.to_dict() for r in jax_fit.telemetry]
    assert out.config.to_dict() == jax_fit.config.to_dict()
    assert (out.converged, out.algorithm) == (jax_fit.converged,
                                              jax_fit.algorithm)


def test_adopt_refuses_k_mismatch_and_sets_stats(jax_fit):
    out = outcome_from_numpy(jax_fit, device=CPU)
    with pytest.raises(ValueError, match="k=8"):
        NestedKMeans(FitConfig(k=9), device=CPU).adopt(out)
    km = NestedKMeans(FitConfig(k=8), device=CPU)
    with pytest.raises(NotFittedError):
        km.export_codebook()
    assert km.adopt(out) is km
    assert isinstance(km.stats_, ClusterStats)
    assert km.stats_.C.device.type == "cpu"
    torch.testing.assert_close(km.stats_.C, out.state.stats.C)
    assert km.telemetry_ == out.telemetry and km.telemetry_ is not \
        out.telemetry
    np.testing.assert_array_equal(km.labels_, out.labels)   # not stale
    km.partial_fit(np.asarray(jax_fit.C) + 0.5)
    with pytest.raises(NotFittedError, match="stale"):
        km.labels_


def test_partial_fit_writes_no_tensor_readers_hold(jax_fit, stream_blobs):
    """Readers hold a `ClusterStats` without a lock: a round must make
    new tensors and leave every held one as it was."""
    km = NestedKMeans(FitConfig(k=8), device=CPU).adopt(
        outcome_from_numpy(jax_fit, device=CPU))
    held = km.stats_
    before = [t.clone() for t in (held.C, held.S, held.v, held.sse, held.p)]
    X = np.random.default_rng(1).normal(size=(200, 16)).astype(np.float32)
    km.partial_fit(X)
    km.partial_fit(X * 2)
    assert km.stats_ is not held
    for t, b in zip((held.C, held.S, held.v, held.sse, held.p), before):
        assert torch.equal(t, b)


def test_export_codebook_copies(jax_fit):
    km = NestedKMeans(FitConfig(k=8), device=CPU).adopt(
        outcome_from_numpy(jax_fit, device=CPU))
    exp = km.export_codebook()
    assert set(exp) == {"centroids", "counts", "n_rounds", "batch_mse"}
    exp["centroids"][0, 0] += 1.0
    assert km.cluster_centers_[0, 0] != exp["centroids"][0, 0]


def test_partial_fit_stream_matches_jax(jax_fit):
    """10 micro-batches into the same adopted codebook: C within 1e-5,
    equal counts and schedule; then equal exports, snapshot checksums,
    labels and distances."""
    j, t = _both(jax_fit)
    S, _ = gaussian_blobs(1000, k=8, dim=16, spread=5.0, seed=2)
    for lo in range(0, 1000, 100):
        j.partial_fit(S[lo:lo + 100])
        t.partial_fit(S[lo:lo + 100])
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               **TOL)
    np.testing.assert_array_equal(t.counts_, j.counts_)
    assert [(r.n_changed, r.n_recomputed, r.b) for r in t.telemetry_] == \
        [(r.n_changed, r.n_recomputed, r.b) for r in j.telemetry_]
    je, te = j.export_codebook(), t.export_codebook()
    assert set(te) == set(je)
    np.testing.assert_allclose(te["centroids"], je["centroids"], **TOL)
    np.testing.assert_array_equal(te["counts"], je["counts"])
    assert te["n_rounds"] == je["n_rounds"]
    np.testing.assert_allclose(te["batch_mse"], je["batch_mse"], **TOL)
    # one exported dict, both packages' snapshots
    assert CodebookSnapshot.create(3, je, device=CPU).checksum == \
        JSnapshot.create(3, je).checksum
    X, _ = gaussian_blobs(400, k=8, dim=16, spread=5.0, seed=3)
    ts = CodebookSnapshot.create(1, te, device=CPU)
    js = JSnapshot.create(1, je, kernel_backend="ref")
    np.testing.assert_array_equal(ts.predict(X), js.predict(X))
    np.testing.assert_allclose(ts.predict_with_distance(X)[1],
                               js.predict_with_distance(X)[1], **TOL)
    np.testing.assert_allclose(ts.transform(X), js.transform(X), **TOL)


def test_services_from_one_codebook_match_jax(jax_fit):
    """Both services over the same adopted codebook, the same rows
    queued, folded by ``stop(drain=True)`` on this thread in the same
    micro-batches: the same versions, refresh metrics, counts and
    labels, C within 1e-5."""
    S, _ = gaussian_blobs(1100, k=8, dim=16, spread=5.0, seed=4)
    svcs = []
    for km, Svc, Q in zip(_both(jax_fit), (JService, ClusterService),
                          (JQueue, IngestQueue)):
        svc = Svc(km, micro_batch=256, queue=Q(max_rows=4096, dedup=True))
        svc.ingest(S, ids=list(range(len(S))))
        svc.ingest(S[:100], ids=list(range(100)))      # redelivered
        svc.stop(drain=True)
        svcs.append(svc)
    (jsv, tsv) = svcs
    jm, tm = jsv.export_metrics(), tsv.export_metrics()
    assert tm["queue"] == jm["queue"]
    assert tm["refresh"]["count"] == jm["refresh"]["count"] == 5
    assert tm["refresh"]["rows"] == jm["refresh"]["rows"] == 1100
    assert tsv.snapshot.version == jsv.snapshot.version == 6
    np.testing.assert_allclose(tsv.snapshot.centroids,
                               jsv.snapshot.centroids, **TOL)
    np.testing.assert_array_equal(tsv.snapshot.counts, jsv.snapshot.counts)
    np.testing.assert_array_equal(tsv.predict(S), jsv.predict(S))


# -- ClusterService ---------------------------------------------------------

def test_service_first_batch_accumulates_below_k(stream_blobs):
    k = 32
    km = NestedKMeans(FitConfig(k=k, b0=64, seed=0), device=CPU)
    svc = ClusterService(km, micro_batch=128, flush_after_s=0.02).start()
    try:
        with pytest.raises(NotFittedError):
            svc.predict(stream_blobs[:4])
        for i in range(0, 4 * k, 5):        # chunks of 5 << k
            svc.ingest(stream_blobs[i:i + 5])
        assert wait_until(lambda: svc.snapshot is not None)
        labels = svc.predict(stream_blobs[:64])
        assert labels.shape == (64,) and labels.max() < k
        v1 = svc.snapshot.version
        svc.ingest(stream_blobs[200:207])
        assert wait_until(lambda: svc.queue.depth == 0)
    finally:
        svc.stop()
    assert svc.snapshot.version > v1
    assert svc.export_metrics()["refresh"]["rows"] >= 4 * k


def test_service_concurrent_predict_no_torn_reads(stream_blobs):
    """Four readers hammer predict for 1 s while the refresher runs:
    every observed snapshot verifies (no torn reads), versions are
    monotone per reader, and each sample lands in the counts once."""
    k = 16
    km = NestedKMeans(FitConfig(k=k, b0=256, seed=0), device=CPU)
    km.fit(stream_blobs[:2000])
    n0 = float(np.sum(km.counts_))
    queue = IngestQueue(max_rows=4096, dedup=True)
    svc = ClusterService(km, queue=queue, micro_batch=256,
                         flush_after_s=0.01).start()
    stop = threading.Event()
    errors, n_reads = [], [0] * 4

    def reader(slot):
        last = 0
        Q = stream_blobs[slot * 100:slot * 100 + 50]
        while not stop.is_set():
            snap = svc.snapshot
            if not snap.verify():
                errors.append(f"torn read at v{snap.version}")
                return
            if snap.version < last:
                errors.append(f"version regressed {last}->{snap.version}")
                return
            last = snap.version
            labels = svc.predict(Q)
            if labels.shape != (50,) or labels.max() >= k:
                errors.append(f"bad labels {labels.shape}")
                return
            n_reads[slot] += 1

    readers = [start_thread(reader, i) for i in range(4)]
    v0 = svc.snapshot.version
    t0 = time.time()
    pos = 2000
    while time.time() - t0 < 1.0 and pos < 6000:
        # every row twice under its id: at-least-once delivery
        for _ in range(2):
            svc.ingest(stream_blobs[pos:pos + 100],
                       ids=list(range(pos, pos + 100)))
        pos += 100
        time.sleep(0.002)
    assert wait_until(lambda: svc.snapshot.version > v0 + 3)
    stop.set()
    join_all(readers)
    svc.stop()
    assert not errors, errors
    assert all(n > 0 for n in n_reads)
    m = svc.export_metrics()
    assert m["refresh"]["count"] >= 4
    assert m["predict"]["requests"] == sum(n_reads)
    assert m["refresh"]["rows"] == pos - 2000
    assert float(np.sum(km.counts_)) == n0 + pos - 2000


def test_service_snapshot_isolated_from_later_refreshes(stream_blobs):
    k = 8
    km = NestedKMeans(FitConfig(k=k, b0=128, seed=0), device=CPU)
    km.fit(stream_blobs[:1000])
    svc = ClusterService(km, micro_batch=64, flush_after_s=0.01).start()
    try:
        held = svc.snapshot
        C_held = held.centroids.copy()
        for i in range(10):
            svc.ingest(stream_blobs[1000 + 64 * i:1000 + 64 * (i + 1)])
        assert wait_until(lambda: svc.snapshot.version >= held.version + 3)
    finally:
        svc.stop()
    assert held.verify()
    np.testing.assert_array_equal(held.centroids, C_held)
    assert svc.snapshot.version > held.version


def test_service_escalates_on_drift(stream_blobs):
    """A manual escalation re-fits on the history reservoir and bumps
    the snapshot version; a drifting stream escalates by itself."""
    k = 8
    km = NestedKMeans(FitConfig(k=k, b0=128, max_rounds=30, seed=0),
                      device=CPU)
    km.fit(stream_blobs[:1000])
    svc = ClusterService(km, micro_batch=128, flush_after_s=0.01,
                         history_rows=1024).start()
    try:
        svc.ingest(stream_blobs[1000:2024])
        assert wait_until(lambda: svc.queue.depth == 0)
    finally:
        svc.stop()
    v_before = svc.snapshot.version
    svc.escalate()
    assert svc.snapshot.version > v_before
    assert svc.export_metrics()["refresh"]["escalations"] == 1
    assert svc.snapshot.verify()

    drift = ClusterService(km, queue=IngestQueue(max_rows=2048),
                           micro_batch=128, history_rows=2048,
                           drift_window=3, drift_factor=2.0)
    drift.ingest(stream_blobs[2024:2536])
    drift.ingest(3.0 * stream_blobs[2536:3560])
    drift.stop(drain=True)
    assert drift.export_metrics()["refresh"]["escalations"] >= 1
    assert drift.snapshot.verify()


def test_service_escalation_resumes_from_checkpoint(stream_blobs,
                                                    tmp_path):
    """escalate(resume=True) continues the checkpointed refit: the
    killed escalation's fit resumed gives the unbroken fit's C."""
    cfg = FitConfig(k=8, b0=128, max_rounds=12, seed=0)

    def service(name, on_round=None):
        km = NestedKMeans(cfg, device=CPU, on_round=on_round)
        km.fit(stream_blobs[:1000])
        # the escalations checkpoint, the first fit did not
        km.config = dataclasses.replace(cfg, checkpoint=CheckpointConfig(
            checkpoint_dir=str(tmp_path / name), save_every=2))
        svc = ClusterService(km, queue=IngestQueue(max_rows=2048),
                             micro_batch=128, history_rows=1024)
        svc.ingest(stream_blobs[1000:2024])
        svc.stop(drain=True)
        return svc, km

    class Killed(Exception):
        pass

    def kill(rec):
        if rec.round == 7 and kill.armed:
            raise Killed

    kill.armed = False
    svc, km = service("killed", kill)
    kill.armed = True
    with pytest.raises(Killed):
        svc.escalate()
    kill.armed = False
    # the killed refit left checkpoints behind for the resume to restore
    assert CheckpointStore(str(tmp_path / "killed")).latest_step() >= 2
    svc.escalate(resume=True)
    unbroken_svc, unbroken = service("unbroken")
    unbroken_svc.escalate()
    np.testing.assert_array_equal(km.cluster_centers_,
                                  unbroken.cluster_centers_)
    assert svc.snapshot.verify()


def test_service_refresher_death_closes_queue(stream_blobs):
    """A refresher that dies closes the queue (producers fail loudly)
    and `stop` raises with the cause."""
    km = NestedKMeans(FitConfig(k=8, b0=128, seed=0), device=CPU)
    km.fit(stream_blobs[:1000])
    svc = ClusterService(km, micro_batch=4, flush_after_s=0.01).start()
    svc.ingest(np.ones((4, 3), np.float32))       # wrong width: dies
    assert wait_until(lambda: svc.queue.closed)
    with pytest.raises(RuntimeError):
        svc.ingest(stream_blobs[:4])
    with pytest.raises(RuntimeError, match="refresher died") as err:
        svc.stop()
    assert err.value.__cause__ is not None


def test_estimator_partial_fit_is_thread_safe(stream_blobs):
    k = 8
    km = NestedKMeans(FitConfig(k=k, b0=128, seed=0), device=CPU)
    km.fit(stream_blobs[:1000])
    n0 = float(np.sum(km.counts_))
    per_thread, batches = 100, 8

    def writer(tid):
        for j in range(batches):
            lo = 1000 + (tid * batches + j) * per_thread
            km.partial_fit(stream_blobs[lo:lo + per_thread])

    join_all([start_thread(writer, i) for i in range(4)])
    assert float(np.sum(km.counts_)) == n0 + 4 * batches * per_thread
    assert km.n_rounds_ == len(km.telemetry_)


# -- metrics ----------------------------------------------------------------

def _observe(mod):
    """The same observations into a package's ServeMetrics and registry."""
    r = mod.MetricsRegistry()
    m = mod.ServeMetrics(registry=r)
    for i in range(40):
        m.observe_predict(0.0005 * (i + 1), 64 + i)
    m.observe_refresh(0.050, 256)
    m.observe_refresh(0.007, 255)
    m.observe_escalation()
    m.observe_ingest()
    r.counter("fit rounds", "completed rounds").inc(3)
    r.gauge("util").set(0.5)
    r.gauge("nan gauge", "not measured").set(float("nan"))
    r.histogram("empty", "no samples")
    return m, r


def test_serve_metrics_and_prometheus_match_jax():
    (jm, jr), (tm, tr) = _observe(jmetrics), _observe(tmetrics)
    q = {"policy": "block", "depth": 3}
    assert tm.to_dict(queue_stats=q) == jm.to_dict(queue_stats=q)
    assert json.dumps(tm.to_dict()) == json.dumps(jm.to_dict())
    assert json.dumps(tr.to_dict()) == json.dumps(jr.to_dict())
    assert tr.to_prometheus() == jr.to_prometheus()
    assert (tm.predict_requests, tm.predict_rows, tm.refreshes,
            tm.refresh_rows, tm.escalations, tm.ingest_calls) == \
        (jm.predict_requests, jm.predict_rows, jm.refreshes,
         jm.refresh_rows, jm.escalations, jm.ingest_calls)


def test_service_metrics_snapshot_gauges(jax_fit):
    _, t = _both(jax_fit)
    svc = ClusterService(t, micro_batch=64)
    d = svc.export_metrics()
    assert set(d) == {"predict", "refresh", "ingest_calls", "queue",
                      "snapshot"}
    assert set(d["snapshot"]) == {"version", "age_s", "n_rounds",
                                  "batch_mse"}
    assert d["snapshot"]["n_rounds"] == len(jax_fit.telemetry)
    assert svc.staleness_s() >= 0.0


def test_histogram_percentiles_within_bucket_factor():
    h = Histogram("t")
    vals = [i / 1000.0 for i in range(1, 1001)]
    for v in vals:
        h.record(v)
    for q in (0.50, 0.99):
        true = vals[int(q * (len(vals) - 1))]
        est = h.percentile(q)
        assert true <= est <= true * Histogram.BASE * 1.001, (q, est, true)
    d = h.to_dict()
    assert d["count"] == 1000 and d["max_s"] == 1.0
    assert abs(d["mean_s"] - sum(vals) / 1000) < 1e-9
    assert set(d) == {"count", "mean_s", "p50_s", "p99_s", "max_s"}
    assert LatencyHistogram is Histogram


def test_registry_semantics():
    r = MetricsRegistry()
    c = r.counter("c", "help")
    assert r.counter("c") is c
    with pytest.raises(ValueError, match="Counter"):
        r.gauge("c")
    with pytest.raises(ValueError, match="negative"):
        c.inc(-1)
    c.inc(2)
    r.gauge("g").set(1.5)
    r.histogram("h").record(0.25)
    d = r.to_dict()
    assert d["counters"]["c"] == 2
    assert d["gauges"]["g"] == 1.5
    assert d["histograms"]["h"]["count"] == 1


def test_prometheus_export_format():
    r = MetricsRegistry()
    r.counter("fit rounds", "completed rounds").inc(3)
    r.gauge("util").set(0.5)
    h = r.histogram("lat", "latency")
    for v in (0.001, 0.01, 0.01, 0.1):
        h.record(v)
    text = r.to_prometheus()
    assert "# TYPE fit_rounds counter\nfit_rounds 3" in text
    assert "# TYPE util gauge\nutil 0.5" in text
    assert "# HELP fit_rounds completed rounds" in text
    counts = [int(m) for m in
              re.findall(r'lat_bucket\{le="[^"]+"\} (\d+)', text)]
    assert counts == sorted(counts)
    assert counts[-1] == 4 and 'le="+Inf"' in text
    assert "lat_count 4" in text
    pat = re.compile(r"^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
                     r'|[a-zA-Z_:][a-zA-Z0-9_:]*(_bucket\{le="[^"]+"\})? '
                     r"[0-9eE.+-]+|[a-zA-Z_:][a-zA-Z0-9_:]* NaN)$")
    assert all(pat.match(line) for line in text.splitlines())


def test_serve_metrics_schema_byte_compatible():
    m = ServeMetrics()
    m.observe_predict(0.002, 128)
    m.observe_refresh(0.050, 256)
    m.observe_escalation()
    m.observe_ingest()
    d = m.to_dict(queue_stats={"rows": 1, "dropped": 0})
    assert set(d) == {"predict", "refresh", "ingest_calls", "queue"}
    assert set(d["predict"]) == {"requests", "rows", "latency"}
    assert set(d["refresh"]) == {"count", "rows", "escalations", "latency"}
    assert set(d["predict"]["latency"]) == {"count", "mean_s", "p50_s",
                                            "p99_s", "max_s"}
    assert d["predict"] == {"requests": 1, "rows": 128,
                            "latency": m.predict_latency.to_dict()}
    assert d["refresh"]["count"] == 1 and d["refresh"]["escalations"] == 1
    assert d["ingest_calls"] == 1
    json.dumps(d)
    from repro_torch.serve.metrics import ServeMetrics as Legacy
    assert Legacy is ServeMetrics

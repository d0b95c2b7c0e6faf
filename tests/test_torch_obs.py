"""The port's observability plane against the JAX package's, on the CPU.

`repro_torch.obs` writes the JAX package's trace format, so a directory
written by either package's `SpanTracer` reads the same in the other and
the two CLIs print the same JSON. `WorkModel` counts k-scans, pair
distances and bytes as JAX does and prices them against the H100 (the
bound is checked against the formula by hand). A traced port fit and a
traced JAX fit of the same config give the same round events, field by
field, but for the timings and the hardware model's numbers (floats at
the f32 tolerance of tests/test_torch_fit.py, rtol 1e-5: the packages'
float sums differ in order), and the same control-flow fingerprint; a
traced fit gives the same bits as an untraced one.
"""
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest

import repro.obs as jobs
from repro.api.config import FitConfig as JConfig
from repro.api.engines import make_engine as jmake_engine
from repro.api.loop import run_loop as jrun_loop
from repro.obs.__main__ import main as jmain
from repro_torch.api import FitConfig, NestedKMeans
from repro_torch.api.engines import make_engine
from repro_torch.api.loop import run_loop
from repro_torch.obs import (FitObserver, SpanTracer, WorkModel,
                             read_events, summarize, trace_files)
from repro_torch.obs.__main__ import main as tmain
from repro_torch.roofline import analysis as roof
from repro_torch.util import tracecount

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the round attributes that depend on the clock or the hardware model
TIMING_OR_MODEL = {"dt_s", "t_work", "utilization", "bound_s", "flops",
                   "bottleneck", "jit_traces"}


def _write_trace(tracer_cls, path):
    with tracer_cls(path, rotate_bytes=4096) as tr:
        with tr.span("outer", phase="warm"):
            tr.event("tick", n=1)
            with tr.span("inner"):
                pass
        for i in range(120):
            tr.event("round", round=i, kscans=10 + i, dt_s=0.5,
                     dist_evals=80, bytes=640, b_global=2 * i,
                     utilization=0.25, val_mse=None, pad="x" * 40)
        tr.event("jit_trace", site="nested_round", n=2)
        tr.event("overflow_retry", n=1)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trace_dirs_read_the_same_in_both_packages(tmp_path, writer):
    _write_trace(SpanTracer if writer == "port" else jobs.SpanTracer,
                 tmp_path)
    assert len(trace_files(tmp_path)) > 1          # rotation happened
    assert trace_files(tmp_path) == jobs.trace_files(tmp_path)
    mine, theirs = read_events(tmp_path), jobs.read_events(tmp_path)
    assert mine == theirs
    assert summarize(mine) == jobs.summarize(theirs)
    s = summarize(mine)
    assert s["rounds"] == 120 and s["jit_traces"] == 2
    assert s["overflow_retries"] == 1


@pytest.mark.parametrize("bounds", ["none", "hamerly2", "elkan", "exponion"])
def test_workmodel_counts_match_jax_and_bound_is_h100(bounds):
    k, d = 50, 784
    mine = WorkModel.for_bounds(k, d, bounds)
    theirs = jobs.WorkModel.for_bounds(k, d, bounds)
    for n in (0, 1, 49, 50, 4_089_297):
        w, j = mine.round_work(n, dt_s=0.01), theirs.round_work(n)
        assert (w.kscans, w.dist_evals, w.hbm_bytes, w.unit) == \
            (j.kscans, j.dist_evals, j.hbm_bytes, j.unit)
        pairs = n * k if mine.unit == "kscan" else n
        rows = n if mine.unit == "kscan" else -(-n // k)
        flops = 3 * 2.0 * d * pairs                 # 3xTF32
        n_bytes = 4.0 * (rows * d + k * d)
        want = max(n_bytes / 3.35e12, flops / 495e12)
        assert w.flops == flops
        assert w.bound_s == pytest.approx(want, rel=1e-12)
        assert w.bottleneck == ("memory" if n_bytes / 3.35e12
                                >= flops / 495e12 else "compute")
        assert w.utilization == pytest.approx(want / 0.01, rel=1e-12)


def test_workmodel_refuses_bad_shapes_and_units():
    with pytest.raises(ValueError, match="k, d"):
        WorkModel(0, 4)
    with pytest.raises(ValueError, match="unit"):
        WorkModel(4, 4, unit="row")
    assert WorkModel(4, 4).round_work(10).utilization is None


def test_roofline_terms_are_the_h100_sxm_rates():
    assert (roof.PEAK_BYTES_S, roof.PEAK_F32_FLOPS, roof.PEAK_TF32_FLOPS) \
        == (3.35e12, 67e12, 495e12)
    r = roof.roofline_terms(67e12, 3.35e12, tf32_flops=495e12)
    assert r.compute_s == pytest.approx(2.0) and r.memory_s == 1.0
    assert r.bottleneck == "compute" and r.step_time_s() == r.compute_s
    assert roof.roofline_terms(0.0, 1.0).bottleneck == "memory"


def test_tracecount_counts_first_sightings():
    before = tracecount.snapshot()
    for rho in (1.0, 1.0, 2.0):
        tracecount.record("test_site", b=8, rho=rho)
    new = tracecount.diff(before)
    assert sorted(n for (s, _), n in new.items() if s == "test_site") \
        == [1, 1]
    again = tracecount.snapshot()
    tracecount.record("test_site", b=8, rho=1.0)      # a cache hit
    assert tracecount.diff(again) == {}


def test_tracecount_since_a_mark_is_the_diff_of_a_snapshot():
    for i in range(50):                # keys seen before the mark
        tracecount.record("test_since", b=i)
    m, before = tracecount.mark(), tracecount.snapshot()
    assert tracecount.since(m) == {}
    for b in (100, 100, 101):
        tracecount.record("test_since", b=b)
    assert tracecount.since(m) == tracecount.diff(before)
    assert sorted(dict(k[1])["b"] for k in tracecount.since(m)) == [
        "100", "101"]
    tracecount.reset()                 # a reset makes every key new
    tracecount.record("test_since", b=100)
    assert list(tracecount.since(m)) == [
        ("test_since", (("b", "100"),))]


def test_obs_package_imports_no_torch():
    code = ("import sys, repro_torch.obs, repro_torch.obs.sink, "
            "repro_torch.obs.__main__; "
            "bad = [m for m in ('torch', 'numpy', 'jax') "
            "if m in sys.modules]; assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# traced fits: the port against JAX
# ---------------------------------------------------------------------------

#: clear of ROADMAP Queue 3 item 1's near-tie (b0=500 at seed 0); b0=256
#: is one of tests/test_torch_fit.py's configurations
FIT = dict(k=8, b0=256, seed=0, max_rounds=30, eval_every=4,
           capacity_floor=32)


def _traced_fit(pkg, td, X, X_val=None, trace=None, **cfg):
    """One fit of ``pkg`` ("port" on the CPU, or "jax" on its plain
    plan) through its own run_loop, traced into ``td``. ``X``: an array
    or an open chunk store of that package."""
    n, d = (X.n, X.d) if hasattr(X, "n_chunks") else X.shape
    if pkg == "port":
        config = FitConfig(**cfg).resolve(n)
        run = make_engine(config).begin(X, config, X_val=X_val,
                                        device="cpu")
        loop, obs_cls = run_loop, FitObserver
    else:
        config = JConfig(kernel_backend="ref", **cfg).resolve(n)
        run = jmake_engine(config).begin(X, config, X_val=X_val)
        loop, obs_cls = jrun_loop, jobs.FitObserver
    with obs_cls(td, k=config.k, d=d, bounds=config.bounds,
                 meta={"backend": "local"}) as obs:
        return loop(run, config, trace=trace, obs=obs)


@pytest.fixture(scope="module")
def traced_pair(tmp_path_factory, blobs, blobs_val):
    X, _ = blobs
    out = {}
    for pkg in ("port", "jax"):
        td = tmp_path_factory.mktemp(f"trace_{pkg}")
        schedule = []
        res = _traced_fit(pkg, td, X, blobs_val, trace=schedule, **FIT)
        out[pkg] = (td, res, schedule)
    return out


def _rounds(td):
    return [e["attrs"] for e in read_events(td) if e.get("name") == "round"]


def test_traced_fit_from_empty_counters_traces_each_bucket_once(
        tmp_path, blobs):
    X, _ = blobs
    for i in range(400):               # keys of earlier fits
        tracecount.record("nested_round", b=-i)
    tracecount.reset()
    _traced_fit("port", tmp_path, X, **FIT)
    buckets = {(r["b_global"], r["capacity"]) for r in _rounds(tmp_path)}
    traces = [e["attrs"] for e in read_events(tmp_path)
              if e.get("name") == "jit_trace"]
    assert summarize(read_events(tmp_path))["jit_traces"] == len(traces) \
        == len(buckets) > 1
    cap = {"None": None}
    assert {(int(t["statics"]["b"]),
             cap.get(t["statics"]["capacity"], t["statics"]["capacity"]))
            for t in traces} == {(b, c if c is None else str(c))
                                 for b, c in buckets}


def test_traced_round_events_match_jax(traced_pair):
    (td, res, sched), (jtd, jres, jsched) = traced_pair["port"], \
        traced_pair["jax"]
    assert sched == jsched and len(sched) > 0       # the fingerprint
    mine, theirs = _rounds(td), _rounds(jtd)
    assert len(mine) == len(theirs) == len(sched)
    for a, b in zip(mine, theirs):
        # jit_traces is there only on a round that met a new key, which
        # depends on what ran before in the process
        assert set(a) - {"jit_traces"} == set(b) - {"jit_traces"}
        for key in set(b) - TIMING_OR_MODEL:
            if isinstance(b[key], float):
                assert a[key] == pytest.approx(b[key], rel=1e-5), key
            else:
                assert a[key] == b[key], key
        assert a["utilization"] is not None and 0 < a["utilization"] <= 1
        assert a["bottleneck"] == "memory"
    s, js = summarize(read_events(td)), jobs.summarize(jobs.read_events(jtd))
    for key in ("rounds", "kscans_total", "dist_evals_total", "bytes_total",
                "overflow_retries", "max_b_global"):
        assert s[key] == js[key], key
    assert s["kscans_total"] == sum(r.n_recomputed for r in res.telemetry)
    names = {e.get("name") for e in read_events(td)}
    assert {"fit_start", "fit_end", "round"} <= names


def test_metrics_json_written_at_close(traced_pair):
    td, res, sched = traced_pair["port"]
    m = json.loads((td / "metrics-p00000.json").read_text())
    assert m["counters"]["fit_rounds"] == len(sched)
    assert m["counters"]["fit_kscans"] == sum(
        r.n_recomputed for r in res.telemetry)
    assert m["histograms"]["fit_round_seconds"]["count"] == len(sched)
    assert 0 < m["gauges"]["fit_roofline_utilization"] <= 1
    jtd = traced_pair["jax"][0]
    jm = json.loads((jtd / "metrics-p00000.json").read_text())
    assert set(m["counters"]) == set(jm["counters"])
    assert set(m["gauges"]) == set(jm["gauges"])


@pytest.mark.parametrize("cmd", [["summarize"], ["tail", "-n", "3"],
                                 ["merge"]])
def test_cli_prints_what_the_jax_cli_prints(traced_pair, capsys, cmd):
    td = str(traced_pair["port"][0])
    assert tmain([cmd[0], td] + cmd[1:]) == 0
    mine = capsys.readouterr().out
    assert jmain([cmd[0], td] + cmd[1:]) == 0
    assert mine == capsys.readouterr().out and mine.strip()
    assert tmain(["summarize", td + "/nope"]) == 2


def test_cli_runs_as_a_module(traced_pair):
    td = str(traced_pair["port"][0])
    env = dict(os.environ, PYTHONPATH="src")
    outs = [subprocess.run([sys.executable, "-m", mod, "summarize", td],
                           env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=120)
            for mod in ("repro_torch.obs", "repro.obs")]
    assert [r.returncode for r in outs] == [0, 0], outs[0].stderr
    assert outs[0].stdout == outs[1].stdout
    assert json.loads(outs[0].stdout)["rounds"] == len(
        traced_pair["port"][2])


def test_trace_dir_is_accepted_and_gives_the_untraced_bits(
        tmp_path, blobs, blobs_val):
    """FitConfig(trace_dir=...) traces the estimator's fit (the port
    refused it before item 8 was ported) and changes no bit of it."""
    X, _ = blobs
    cfg = FitConfig(k=8, b0=1000)
    traced = NestedKMeans(FitConfig(k=8, b0=1000, trace_dir=str(
        tmp_path / "tr")), device="cpu").fit(X, X_val=blobs_val)
    plain = NestedKMeans(cfg, device="cpu").fit(X, X_val=blobs_val)
    np.testing.assert_array_equal(traced.cluster_centers_,
                                  plain.cluster_centers_)
    np.testing.assert_array_equal(traced.labels_, plain.labels_)

    def tel(km):
        return [{k: v for k, v in r.to_dict().items() if k != "t"}
                for r in km.telemetry_]
    assert tel(traced) == tel(plain)
    names = sorted(p.name for p in (tmp_path / "tr").iterdir())
    assert names == ["metrics-p00000.json", "trace-p00000-0000.jsonl"]
    s = summarize(read_events(tmp_path / "tr"))
    rounds = [r for r in traced.telemetry_ if r.batch_mse is not None]
    assert s["rounds"] == len(rounds)
    assert s["kscans_total"] == sum(r.n_recomputed for r in rounds)
    start = next(e for e in read_events(tmp_path / "tr")
                 if e.get("name") == "fit_start")["attrs"]
    assert (start["k"], start["d"], start["algorithm"], start["n_points"]) \
        == (8, 16, "tb", 4000)


def test_store_fit_traces_ingest_like_jax(tmp_path):
    """A traced store-backed fit reports each prefix growth as an
    ``ingest`` span with the rows it placed, and the store's read
    counters as per-round deltas, as the JAX engine does."""
    from repro.data.store import ChunkStore as JStore
    from repro_torch.data.store import ChunkStore, write_store
    X = np.random.default_rng(0).normal(size=(3000, 6)).astype(np.float32)
    write_store(tmp_path / "st", X, chunk_rows=256)
    spans = {}
    for pkg, store_cls in (("port", ChunkStore), ("jax", JStore)):
        with store_cls(tmp_path / "st") as st:
            _traced_fit(pkg, tmp_path / pkg, st, k=5, b0=200,
                        max_rounds=25, capacity_floor=32)
        ev = jobs.read_events(tmp_path / pkg)
        spans[pkg] = [e["attrs"]["rows"] for e in ev
                      if e.get("name") == "ingest"]
        rounds = [e["attrs"] for e in ev if e.get("name") == "round"]
        assert all("store_bytes_read" in r for r in rounds)
        assert sum(r["store_bytes_read"] for r in rounds) > 0
    assert spans["port"] == spans["jax"] and spans["port"]
    assert sum(spans["port"]) <= 3000


# ---------------------------------------------------------------------------
# the port's spans: always-on root totals, the JSONL, the profiler
# ---------------------------------------------------------------------------

#: small enough for a fit in about a second on one CPU thread
SPAN_FIT = dict(k=4, b0=128, seed=0, max_rounds=14, eval_every=4,
                capacity_floor=16)


def _span_data():
    rng = np.random.default_rng(5)
    X = (rng.normal(size=(1500, 8)) + 6.0 * rng.integers(
        0, 4, size=(1500, 1))).astype(np.float32)
    return X, X[:200].copy()


@pytest.fixture(scope="module")
def spanned_fit(tmp_path_factory):
    """One traced estimator fit and predict on the CPU; every round
    attempt counted where the engine makes it (`rounds.nested_round`)."""
    from repro_torch import obs
    from repro_torch.core import rounds
    X, X_val = _span_data()
    td = tmp_path_factory.mktemp("spans")
    calls = []
    orig = rounds.nested_round

    def counted(*args, **kw):
        calls.append(kw["capacity"])
        return orig(*args, **kw)
    rounds.nested_round = counted
    try:
        km = NestedKMeans(FitConfig(trace_dir=str(td), **SPAN_FIT),
                          device="cpu").fit(X, X_val=X_val)
    finally:
        rounds.nested_round = orig
    km.predict(X)
    return {"km": km, "fit": obs.recent_roots("estimator.fit")[-1],
            "predict": obs.recent_roots("estimator.predict")[-1],
            "attempts": len(calls), "dir": td}


@pytest.fixture(scope="module")
def unshuffled_fit(tmp_path_factory):
    """A short traced fit of the same rows with ``shuffle=False``."""
    from repro_torch import obs
    X, X_val = _span_data()
    td = tmp_path_factory.mktemp("unshuffled")
    cfg = dict(SPAN_FIT, max_rounds=2)
    NestedKMeans(FitConfig(trace_dir=str(td), shuffle=False, **cfg),
                 device="cpu").fit(X, X_val=X_val)
    return {"fit": obs.recent_roots("estimator.fit")[-1], "dir": td}


def _segments(n, d):
    """The staging segments of an in-memory placement of n rows of d."""
    from repro_torch.api.engines import local
    return -(-n // max(1, local._STAGE_BYTES // (4 * d)))


def test_a_fit_spans_its_placement_once_and_each_round_attempt(
        spanned_fit, unshuffled_fit):
    root, km = spanned_fit["fit"], spanned_fit["km"]
    assert root.ok and root.name == "estimator.fit"
    for name in ("engine.place", "engine.shuffle", "engine.fingerprint",
                 "loop.outcome"):
        assert root.total(name)[1] == 1, name
    assert root.total("engine.upload")[1] == 2          # X and X_val
    # one scatter of a staging segment to its shuffled rows, none
    # unshuffled
    assert root.total("engine.scatter")[1] == _segments(1500, 8)
    plain = unshuffled_fit["fit"]
    assert plain.total("engine.upload")[1] == 2
    assert plain.total("engine.scatter") == (0.0, 0)
    attempts = spanned_fit["attempts"]
    rounds = [r for r in km.telemetry_ if r.batch_mse is not None]
    assert attempts >= len(rounds) > 3
    for name in ("loop.issue", "loop.fetch", "round.decide",
                 "round.assign", "round.sums", "round.update"):
        assert root.total(name)[1] == attempts, name
    assert root.total("loop.schedule")[1] == len(rounds)
    # the rounds' work clock is the attempts' issue and wait
    t = km.telemetry_[-1].t
    waited = root.total("loop.issue")[0] + root.total("loop.fetch")[0]
    assert waited == pytest.approx(t, rel=0.05)
    # the evals of the cadence and the final one
    evals = [r for r in km.telemetry_ if r.val_mse is not None]
    assert root.total("eval_mse")[1] == len(evals)
    assert root.seconds == root.total("estimator.fit")[0] > t
    pred = spanned_fit["predict"]
    assert {n: c for n, (_, c) in pred.totals().items()} == {
        "estimator.predict": 1, "predict.upload": 1, "predict.assign": 1,
        "predict.labels": 1}
    assert pred.id != root.id


def test_a_trace_dir_fit_writes_its_placement_spans(spanned_fit,
                                                    unshuffled_fit):
    spans = [e for e in read_events(spanned_fit["dir"])
             if e.get("ph") == "span"]
    place = [e for e in spans if e["name"] == "engine.place"]
    assert len(place) == 1
    inside = sorted(e["name"] for e in spans
                    if e["parent"] == place[0]["id"])
    assert inside == ["engine.fingerprint", "engine.shuffle",
                      "engine.upload", "engine.upload"]
    # the scatters lie inside X's upload, the first of the two
    uploads = sorted((e for e in spans if e["name"] == "engine.upload"),
                     key=lambda e: e["id"])
    scatters = [e for e in spans if e["name"] == "engine.scatter"]
    assert len(scatters) == _segments(1500, 8)
    assert {e["parent"] for e in scatters} == {uploads[0]["id"]}
    plain = [e["name"] for e in read_events(unshuffled_fit["dir"])
             if e.get("ph") == "span"]
    assert plain.count("engine.upload") == 2
    assert "engine.scatter" not in plain
    names = {e["name"] for e in spans}
    assert {"loop.issue", "loop.fetch", "loop.schedule", "eval_mse",
            "round.decide", "loop.outcome"} <= names
    # the fit_start event keeps the engine's fields, written after it
    # placed the data
    start = next(e for e in read_events(spanned_fit["dir"])
                 if e.get("name") == "fit_start")["attrs"]
    assert (start["n_points"], start["n_shards"], start["d"]) == \
        (1500, 1, 8)


def test_spans_are_plain_cpu_ops_under_the_profiler_and_absent_without():
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    X, _ = _span_data()
    cfg = FitConfig(**dict(SPAN_FIT, max_rounds=3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        NestedKMeans(cfg, device="cpu").fit(X)
    mine = [e for e in prof.events()
            if e.name.split(".")[0] in ("estimator", "engine", "loop",
                                        "round")]
    assert {"estimator.fit", "engine.place", "loop.issue", "loop.fetch",
            "round.decide", "round.assign"} <= {e.name for e in mine}
    assert not any(e.is_user_annotation for e in mine)
    # a fit in the profiler's warm-up step, which records nothing, and
    # none outside it: no span reaches the trace
    got = {}
    prof = profile(activities=[ProfilerActivity.CPU],
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=lambda p: got.update(
                       names={e.name for e in p.events()}))
    NestedKMeans(cfg, device="cpu").fit(X)
    with prof:
        NestedKMeans(cfg, device="cpu").fit(X)
        prof.step()
        torch.ones(4).sum()
        prof.step()
    assert got["names"] and not any(
        n.startswith(("estimator.", "engine.", "loop.", "round."))
        for n in got["names"])


def test_roots_on_two_threads_keep_their_own_totals():
    import threading
    from repro_torch.obs import recent_roots, span
    both_open = threading.Barrier(2, timeout=30)
    done = threading.Barrier(2, timeout=30)

    def work(inner, n):
        with span("test.two_threads"):
            both_open.wait()
            for _ in range(n):
                with span(inner):
                    pass
            done.wait()

    threads = [threading.Thread(target=work, args=("test.a", 3)),
               threading.Thread(target=work, args=("test.b", 5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    a, b = sorted(recent_roots("test.two_threads")[-2:],
                  key=lambda r: r.total("test.a")[1], reverse=True)
    assert (a.total("test.a")[1], a.total("test.b")[1]) == (3, 0)
    assert (b.total("test.a")[1], b.total("test.b")[1]) == (0, 5)
    assert a.id != b.id and a.thread != b.thread

"""CPU tests of the benchmark: the manifest and its files, the yardstick,
the reference, the data recipes, what the harness imports, and whole
runs at small sizes, sound, with the control in the program's place, and
with each fault a cell can have planted in the program.

The runs here take the harness past its look for a card (``device=
"cpu"``): the program takes its plain versions there. Tests that need
the card are marked ``gpu`` and skip without one:

    PYTHONPATH=src python -m pytest -q -m gpu perfbench/test_perfbench.py
"""
import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import datagen, harness, loops, profiling, yardstick
from perfbench.reference import kmeans as ref

BENCH = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BLOBS = {"n_points": 2048, "k": 128,
         "data": {"recipe": "blobs", "centres": 128, "spread": 5.0,
                  "codebook": 128}}
#: where the control's near-ties are many enough on every seed tried
CONTROL = {"n_points": 8192, "k": 256,
           "data": {"recipe": "blobs", "centres": 256, "spread": 5.0,
                    "codebook": 256}}
#: each cell at a size the CPU runs in about a second
SMALL = {"infmnist.fit": {"n_points": 2000, "n_val": 300, "b0": 250},
         "kmeans_xl.dp_round": BLOBS, "kmeans_xl.predict": BLOBS}


@pytest.fixture(autouse=True)
def one_thread():
    """The runs here are many small CPU ops: with a thread pool each,
    several test workers on one host spin against each other (a traced
    fit took 338 s of its 5 s so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _run(workload, seed=20260001):
    return harness.run(workload, seed, 0.0, False, device="cpu",
                       overrides=SMALL[workload], log=lambda line: None)


def test_manifest_names_every_file_and_keeps_its_forms():
    man = harness.manifest()
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in man["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        c = harness.cell(w["name"], man)
        assert c.traffic["kind"] in loops.LOOPS
        assert c.reference().judge_labels
        assert c.limits and all(v > 0 for v in c.limits.values())
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in reported
    for conf in man["configs"]:
        body = json.loads((BENCH.parent / conf["file"]).read_text())
        assert body["name"] == conf["name"]
        assert body["reduced"] == conf["reduced"]
        assert all(k in body for k in conf["reduced"])
        assert (BENCH / "reference" / f"{body['reference']}.py").is_file()


def test_bounds_of_the_production_calls():
    # kernel 4 at one chip's kmeans_xl share: 3xTF32 products and the f32
    # adds into S (the dry run's kernel_analytic reads the same)
    assert round(yardstick.fused_round(2 ** 22, 4096, 1024) * 1e3, 3) \
        == 213.303
    # kernel 1 on one predict request of 2^20 rows
    assert round(yardstick.assign_top2(2 ** 20, 4096, 1024) * 1e3, 2) \
        == 53.31
    # a bytes-bound call: x read once dominates at k = 50
    b = yardstick.assign_top2(400_000, 50, 784)
    assert b == pytest.approx((4 * 400_000 * 784 + 4 * 50 * 784
                               + 12 * 400_000) / yardstick.PEAK_BYTES_S)


def test_reference_against_a_float64_brute_force():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 17)).astype(np.float32)
    C = rng.normal(size=(9, 17)).astype(np.float32)
    d2 = ((X[:, None, :].astype(np.float64) - C[None]) ** 2).sum(-1)
    a, d1, dd = ref.assign(torch.from_numpy(X), torch.from_numpy(C),
                           "float64")
    np.testing.assert_array_equal(a.numpy(), d2.argmin(1))
    np.testing.assert_allclose(d1.numpy(), d2.min(1), rtol=1e-12)
    np.testing.assert_allclose(dd.numpy(), np.sort(d2, 1)[:, 1], rtol=1e-12)
    S, v = ref.sums(torch.from_numpy(X), a, 9, "float64")
    for j in range(9):
        np.testing.assert_allclose(S[j].numpy(), X[d2.argmin(1) == j].astype(
            np.float64).sum(0), rtol=1e-12, atol=1e-12)
        assert v[j] == (d2.argmin(1) == j).sum()
    good = ref.judge_labels(torch.from_numpy(X), torch.from_numpy(C), a,
                            d1.sqrt().float())
    assert good["label_gap"] < 1e-12 and good["dist_err"] < 1e-6
    wrong = a.clone()
    wrong[0] = (wrong[0] + 1) % 9
    assert ref.judge_labels(torch.from_numpy(X), torch.from_numpy(C),
                            wrong)["label_gap"] > 1e-3
    # the control's operands carry 10 mantissa bits
    t = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0])
    assert ref.tf32(t).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]


def test_device_recipes_are_seeded_and_in_range():
    conf = {"n_points": 500, "n_val": 50, "dim": 784,
            "data": {"recipe": "infmnist_like", "n_classes": 10,
                     "deform": 1.5, "noise": 0.05}}
    a = datagen.make(conf, 2 ** 33 + 5, "cpu")
    b = datagen.make(conf, 2 ** 33 + 5, "cpu")
    c = datagen.make(conf, 7, "cpu")
    assert a["X"].shape == (500, 784) and a["X_val"].shape == (50, 784)
    assert float(a["X"].min()) >= 0.0 and float(a["X"].max()) <= 1.0
    assert float(a["X"].std()) > 0.05
    assert torch.equal(a["X"], b["X"]) and not torch.equal(a["X"], c["X"])
    conf = {"n_points": 1000, "dim": 64,
            "data": {"recipe": "blobs", "centres": 8, "spread": 5.0,
                     "codebook": 8}}
    x = datagen.make(conf, 11, "cpu")
    assert x["X"].shape == (1000, 64) and x["codebook"].shape == (8, 64)
    assert torch.equal(x["X"], datagen.make(conf, 11, "cpu")["X"])
    conf["data"]["seed"] = 3                    # one fixed data set
    assert torch.equal(datagen.make(conf, 11, "cpu")["X"],
                       datagen.make(conf, 12, "cpu")["X"])
    assert 20 < float(x["X"].std()) ** 2 < 30     # 5^2 spread + unit noise


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if path.name != "test_perfbench.py":
            assert not re.search(r"""["'/]benchmarks\b""",
                                 path.read_text()), path
    for path in (BENCH / "reference").glob("*.py"):
        assert not {m.split(".")[0] for m in _imports(path)} & {
            "repro_torch", "perfbench"}, path


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_is_correct_and_prints_its_metrics(workload):
    out = _run(workload)
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(out)[-1] == "checks"
    assert set(out["checks"]) == set(harness.cell(workload).limits)
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2


def test_every_fit_window_holds_the_same_shuffles_each_as_often():
    c = harness.cell("infmnist.fit", overrides=SMALL["infmnist.fit"])
    fixed = sorted(c.traffic["shuffle_seeds"])
    lp = loops.FitLoop(c.config, c.traffic, 2 ** 31 + 11, "cpu",
                       c.reference())
    lp.setup()
    seen, fit = [], lp._fit
    lp._fit = lambda cfg: (seen.append(cfg.seed), fit(cfg))[1]
    units, _ = harness.window(lp, 0.0)
    assert len(units) == lp.cycle == len(fixed)
    assert seen == lp.order and sorted(seen) == fixed


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_traced_run_reads_the_per_layer_metrics(workload):
    out = harness.run(workload, 7, 0.0, True, device="cpu",
                      overrides=SMALL[workload], log=lambda line: None)
    want = {m["name"] for m in harness.cell(workload).per_layer}
    # the device's idle share needs the card's trace
    assert set(out["metrics"]) == {m for m in want
                                   if not m.startswith("device.idle")}
    assert out["correct"] is True


@pytest.mark.parametrize("workload", ["kmeans_xl.dp_round",
                                      "kmeans_xl.predict"])
def test_the_tf32_control_fails_the_check(workload):
    c = harness.cell(workload, overrides=CONTROL)
    lp = loops.LOOPS[c.traffic["kind"]](c.config, c.traffic, 5, "cpu",
                                             c.reference())
    lp.setup()
    correct, failed, _ = harness.check(lp.control(), c.limits)
    assert not correct and failed >= 1


@pytest.mark.gpu
def test_the_fit_control_fails_the_check_on_the_card(cuda):
    c = harness.cell("infmnist.fit")
    lp = loops.FitLoop(c.config, c.traffic, 31, cuda, c.reference())
    lp.setup()
    correct, failed, _ = harness.check(lp.control(), c.limits)
    assert not correct and failed == 1


def _unchanged_round(mp):
    from repro_torch.core import distributed
    mp.setattr(distributed, "_centroid_step",
               lambda S, v, sse, C: (C, torch.zeros_like(v)))


def _unchanged_fit(mp):
    import dataclasses
    from repro_torch.core import rounds
    mp.setattr(rounds, "centroid_update", lambda s: dataclasses.replace(
        s, p=torch.zeros_like(s.v)))


def _half_sums(mp):
    """Every sum over the first half of its rows, as if the rest were
    left out."""
    from repro_torch.kernels import ref as plain
    orig = plain.cluster_sum_ref

    def half(x, a, k, *, weights=None):
        w = torch.ones(a.shape[0]) if weights is None else weights.clone()
        w[a.shape[0] // 2:] = 0.0
        return orig(x, a, k, weights=w)
    mp.setattr(plain, "cluster_sum_ref", half)


def _half_labels(mp):
    from repro_torch.kernels import ops
    orig = ops.assign_top2

    def half(x, c, **kw):
        a, d1, d2 = orig(x[:x.shape[0] // 2], c, **kw)
        pad = x.shape[0] - a.shape[0]
        return (torch.cat([a, a.new_zeros(pad)]),
                torch.cat([d1, d1.new_zeros(pad)]),
                torch.cat([d2, d2.new_zeros(pad)]))
    mp.setattr(ops, "assign_top2", half)


def _altered(mp, module, name, k, labels_of=lambda out: out[0]):
    """One label altered where ``module.name`` produces it."""
    orig = getattr(module, name)

    def altered(*args, **kw):
        out = orig(*args, **kw)
        labels = labels_of(out)
        labels[0] = (labels[0] + 1) % k
        return out
    mp.setattr(module, name, altered)


def _altered_round(mp):
    from repro_torch.kernels import ops
    _altered(mp, ops, "fused_round", BLOBS["k"])


def _altered_predict(mp):
    from repro_torch.kernels import ops
    _altered(mp, ops, "assign_top2", BLOBS["k"])


def _altered_fit(mp):
    from repro_torch.api import estimator
    _altered(mp, estimator.NestedKMeans, "predict", 50, lambda out: out)


FAULTS = {
    ("kmeans_xl.dp_round", "state_unchanged"): _unchanged_round,
    ("kmeans_xl.dp_round", "half_the_batch"): _half_sums,
    ("kmeans_xl.dp_round", "answer_altered"): _altered_round,
    ("kmeans_xl.predict", "half_the_batch"): _half_labels,
    ("kmeans_xl.predict", "answer_altered"): _altered_predict,
    ("infmnist.fit", "state_unchanged"): _unchanged_fit,
    ("infmnist.fit", "half_the_batch"): _half_sums,
    ("infmnist.fit", "answer_altered"): _altered_fit,
}


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_a_run_with_a_fault_planted_is_not_correct(workload, fault,
                                                   monkeypatch):
    FAULTS[(workload, fault)](monkeypatch)
    out = _run(workload)
    assert out["correct"] is False and out["failed"] >= 1, out["checks"]


class _Event:
    def __init__(self, name, start, end, cuda, thread=1):
        self.name, self.thread = name, thread
        self.device_type = "DeviceType.CUDA" if cuda else "DeviceType.CPU"
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_trace_reading_of_busy_time_and_idle_gaps():
    events = [_Event("ProfilerStep#1", 0, 1000, False),
              _Event("aten::mm", 100, 300, False),
              _Event("cudaLaunchKernel", 110, 120, False),
              _Event("cudaStreamSynchronize", 500, 900, False),
              _Event("gemm", 150, 400, True),
              _Event("gemm", 350, 450, True),
              _Event("scatter", 600, 800, True)]
    got = profiling.read_trace(events)
    assert got["window_s"] == pytest.approx(1000e-6)
    assert got["busy_s"] == pytest.approx(500e-6)
    assert got["device_ops"][0] == ["gemm", pytest.approx(350e-6)]
    gaps = dict(got["idle_gaps"])
    # 0-150 before the first operation, 450-600 and 800-1000 while the
    # host waits in the synchronise
    assert gaps == {"python": pytest.approx(150e-6),
                    "cudaStreamSynchronize": pytest.approx(350e-6)}
    assert profiling.read_trace(events[:4]) is None

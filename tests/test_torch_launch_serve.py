"""The port's serve entry point and its codebook, against the JAX package.

`repro_torch.launch.serve` (`build_codebook`, `generate`, `main`) and
`ClusterService` over the sharded backends, on the CPU:

* `build_codebook` on the local engine against JAX's `build_codebook`
  from the same embedding table (the reduced tinyllama's, JAX's weights
  from ``PRNGKey(1)``) and from the same chunk store, to the tolerances
  of tests/test_torch_fit.py: labels, schedule and convergence equal,
  centroids at rtol=atol=1e-5. Its checkpoint, resume and trace options.
* The port of tests/test_serve.py:307: a service whose estimator fits on
  a one-rank gloo ``mesh`` or ``xl`` mesh refreshes through the engine's
  `partial_fit` and counts each row once; `build_codebook` over that
  group equals the local one bit for bit.
* 2 spawned gloo ranks (`tests/torch_dist_worker.py`, case ``codebook``):
  each backend's adopted codebook against the one-rank codebook (rtol
  1e-5), its local service, and the refusal of a service over a sharded
  estimator of more than one rank.
* `main` as a subprocess with ``--device cpu``, and in-process for its
  flags and for the encdec (whisper-tiny) and vlm (internvl2-76b)
  models beside JAX's CLI run in the same process.

Every join and wait is bounded (the spawn's 120 s, the subprocess's
timeout, a 20 s deadline on each wait).
"""
import dataclasses
import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as worker
from repro import configs as jconfigs
from repro.data.synthetic import gaussian_blobs
from repro.launch.serve import build_codebook as jbuild_codebook
from repro.models import model as JM
from repro_torch import configs
from repro_torch.api import FitConfig, NestedKMeans
from repro_torch.data.store import ChunkStore, write_store
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as TM
from repro_torch.serve import ClusterService

CPU = "cpu"
TOL = dict(rtol=1e-5, atol=1e-5)
DEADLINE = 20.0
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def table():
    """The reduced tinyllama's embedding table (512, 64) as f32, from the
    JAX package's weights at PRNGKey(1)."""
    cfg = jconfigs.get_reduced("tinyllama-1.1b")
    return np.asarray(JM.init_params(jax.random.PRNGKey(1), cfg)["embed"],
                      np.float32)


def _schedule(km):
    return [(r.b, r.n_recomputed, r.n_changed, r.grow)
            for r in km.telemetry_]


def _assert_same_fit(t, j):
    np.testing.assert_array_equal(t.labels_, j.labels_)
    assert _schedule(t) == _schedule(j)
    assert t.converged_ == j.converged_
    np.testing.assert_allclose(t.cluster_centers_, j.cluster_centers_,
                               **TOL)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait_until(pred, timeout=DEADLINE):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


# -- build_codebook ----------------------------------------------------------

@pytest.mark.parametrize("k", [16, 32])
def test_build_codebook_matches_jax(table, k):
    j = jbuild_codebook(table, k, 0)
    t = serve.build_codebook(table, k, 0, device=CPU)
    _assert_same_fit(t, j)
    assert t.config.b0 == 2 * k and t.config.max_rounds == 200
    assert t.config.backend == "local" and t.device.type == "cpu"
    np.testing.assert_array_equal(t.predict(table), j.predict(table))


def test_build_codebook_from_a_store_matches_jax(table, tmp_path):
    """The same chunk store, as a path in JAX and as a path and an open
    store in the port; both equal the in-memory fit of the port's."""
    write_store(tmp_path / "st", table, chunk_rows=128)
    j = jbuild_codebook(str(tmp_path / "st"), 16, 0)
    t = serve.build_codebook(str(tmp_path / "st"), 16, 0, device=CPU)
    _assert_same_fit(t, j)
    with ChunkStore(tmp_path / "st") as st:
        t2 = serve.build_codebook(st, 16, 0, device=CPU)
    np.testing.assert_array_equal(t2.cluster_centers_, t.cluster_centers_)


def test_build_codebook_checkpoints_resumes_and_traces(table, tmp_path):
    with pytest.raises(ValueError, match="--resume needs --checkpoint-dir"):
        serve.build_codebook(table, 16, 0, resume=True, device=CPU)
    ck, tr = str(tmp_path / "ck"), str(tmp_path / "tr")
    first = serve.build_codebook(table, 16, 0, checkpoint_dir=ck,
                                 save_every=5, trace_dir=tr, device=CPU)
    assert any(Path(ck).iterdir()) and any(Path(tr).rglob("*.jsonl"))
    again = serve.build_codebook(table, 16, 0, checkpoint_dir=ck,
                                 save_every=5, resume=True, device=CPU)
    np.testing.assert_array_equal(again.cluster_centers_,
                                  first.cluster_centers_)
    assert _schedule(again) == _schedule(first)


def test_sharded_backends_need_a_process_group(table):
    assert not dist.is_initialized()
    for backend in ("mesh", "xl"):
        with pytest.raises(RuntimeError, match="process group"):
            serve.build_codebook(table, 16, 0, backend=backend, device=CPU)


# -- the service over a sharded estimator --------------------------------

@pytest.fixture
def one_rank_group():
    """A one-rank gloo group in this process, destroyed after (a later
    test in the same worker expects none)."""
    dist.init_process_group("gloo", init_method=(
        f"tcp://localhost:{_free_port()}"), world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend", ["mesh", "xl"])
def test_service_background_refresh_runs_sharded(one_rank_group, backend):
    """tests/test_serve.py:307 on the port: the estimator fits on a
    one-rank (data, model) mesh and the service's background refresher
    folds 1024 rows in through the engine's partial_fit."""
    X, _ = gaussian_blobs(6000, k=8, dim=8, spread=5.0, seed=0)
    mesh = make_host_mesh((1, 1), ("data", "model"))
    km = NestedKMeans(FitConfig(k=8, b0=256, max_rounds=30, seed=0,
                                backend=backend), mesh=mesh, device=CPU)
    km.fit(X[:1000])
    svc = ClusterService(km, micro_batch=256, flush_after_s=0.01).start()
    try:
        n0 = float(np.sum(km.counts_))
        svc.ingest(X[1000:2024])
        assert _wait_until(lambda: svc.queue.depth == 0)
    finally:
        svc.stop()
    assert float(np.sum(km.counts_)) == pytest.approx(n0 + 1024)
    assert svc.export_metrics()["refresh"]["rows"] == 1024
    labels = svc.predict(X[:64])
    assert labels.shape == (64,) and labels.max() < 8
    assert svc.snapshot.verify()


def test_one_rank_sharded_codebooks_equal_local(one_rank_group, table):
    local = serve.build_codebook(table, 16, 0, device=CPU)
    for backend in ("mesh", "xl", "multihost"):
        km = serve.build_codebook(table, 16, 0, backend=backend, device=CPU)
        assert km.config.backend == "local"
        np.testing.assert_array_equal(km.cluster_centers_,
                                      local.cluster_centers_)
        np.testing.assert_array_equal(km.counts_, local.counts_)
        assert _schedule(km) == _schedule(local)


def test_two_ranks_adopt_the_codebook_and_refuse_the_service(table,
                                                            tmp_path):
    """2 gloo ranks build the codebook on mesh (2, 1) and xl (1, 2),
    k_local 8: both ranks hold the same adopted local codebook, within
    rtol 1e-5 of the one-rank codebook; its service folds each of the 96
    rows delivered twice in once; a service over a sharded estimator of
    the 2 ranks raises its ValueError."""
    one = serve.build_codebook(table, 16, 0, device=CPU)
    ranks = worker.spawn(tmp_path, "codebook", (2,), ("data",), E=table,
                         k=np.int64(16))
    for b in worker.CODEBOOK_BACKENDS:
        for r in ranks:
            assert str(r[f"engine_{b}"]) == "local"
            np.testing.assert_array_equal(r[f"C_{b}"], ranks[0][f"C_{b}"])
            assert float(r[f"folded_{b}"]) == worker.CODEBOOK_SERVED
            assert int(r[f"rows_{b}"]) == worker.CODEBOOK_SERVED
            assert bool(r[f"verified_{b}"])
            assert r[f"labels_{b}"].shape == (len(table),)
            assert re.search(r"over 2 ranks.*Adopt the sharded fit",
                             str(r[f"refused_{b}"]))
        np.testing.assert_allclose(ranks[0][f"C_{b}"],
                                   one.cluster_centers_, **TOL)


# -- generate and the CLI ----------------------------------------------------

def test_generate_is_greedy_decode_with_ingestion():
    """`generate`'s tokens are the argmax of prefill then of each decode
    step, and a service gets each step's embeddings keyed by token id."""
    cfg = configs.get_reduced("tinyllama-1.1b")
    params = TM.init_params(0, cfg, CPU)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (3, 8)))
    E = params["embed"].float().numpy()

    class Recorder:
        def __init__(self):
            self.calls = []

        def ingest(self, X, ids=None):
            self.calls.append((np.array(X), list(ids)))

    rec = Recorder()
    out = serve.generate(cfg, params, tokens, 5, service=rec, E=E)
    gen = out["gen"]
    assert gen.shape == (3, 5) and gen.dtype == np.int32
    assert out["t_prefill"] > 0 and out["t_decode"] > 0
    seq = tokens
    for i in range(5):
        logits, _ = serve.tstep.make_prefill_step(cfg, cache_len=16)(
            params, {"tokens": seq})
        np.testing.assert_array_equal(gen[:, i],
                                      logits[:, -1].argmax(-1).numpy())
        seq = torch.cat([seq, torch.from_numpy(gen[:, i:i + 1]).long()], 1)
    assert [ids for _, ids in rec.calls] == [gen[:, i].tolist()
                                             for i in range(1, 5)]
    for X, ids in rec.calls:
        np.testing.assert_array_equal(X, E[ids])


def test_cli_serves_on_the_cpu():
    """``python -m repro_torch.launch.serve --device cpu --codebook 16``:
    rc 0 and the JAX CLI's lines."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "tinyllama-1.1b", "--device", "cpu", "--codebook", "16",
         "--gen", "6"], capture_output=True, text=True, timeout=120,
        env=env, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    out = p.stdout
    m = re.search(r"codebook: k=16 over \(512, 64\) embeddings in "
                  r"[\d.]+s \(rounds=(\d+), converged=True\)", out)
    assert m and int(m.group(1)) > 0, out
    assert re.search(r"tinyllama-1.1b: prefill 4x32 in [\d.]+ms; 5 decode "
                     r"steps in [\d.]+ms \(\d+ tok/s\) on cpu", out), out
    ids = json.loads(re.search(r"generated token ids \(row 0\): (\[.*\])",
                         out).group(1))
    cells = json.loads(re.search(r"codebook cells  \(row 0\): (\[.*\])",
                           out).group(1))
    assert len(ids) == len(cells) == 6
    assert all(0 <= i < 512 for i in ids) and all(0 <= c < 16
                                                   for c in cells)
    m = re.search(r"codebook service: (\d+) background refreshes over "
                  r"(\d+) embeddings, snapshot v(\d+) \(deduped=(\d+), "
                  r"batch MSE [\d.]+\)", out)
    # 4 rows a decode step, 5 steps: each id folded in once
    assert m and int(m.group(2)) + int(m.group(4)) == 20, out


def test_cli_flags(monkeypatch, capsys):
    """--no-reduced reaches get_config (JAX's --reduced could never be
    turned off); a sharded --codebook-backend joins a one-rank group of
    its own and leaves it; the fit's flags need --codebook; --device
    cuda without a card fails."""
    asked = []
    reduced = configs.get_reduced("tinyllama-1.1b")

    def get_config(arch):
        asked.append(arch)
        return reduced

    monkeypatch.setattr(serve.configs, "get_config", get_config)
    base = ["--arch", "tinyllama-1.1b", "--device", "cpu", "--gen", "3"]
    serve.main(base + ["--no-reduced", "--codebook", "8",
                       "--codebook-backend", "xl"])
    assert asked == ["tinyllama-1.1b"] and not dist.is_initialized()
    assert "codebook service:" in capsys.readouterr().out
    serve.main(base)
    assert asked == ["tinyllama-1.1b"]
    with pytest.raises(SystemExit):
        serve.main(base + ["--resume"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            serve.main(["--arch", "tinyllama-1.1b"])


def test_adopted_codebook_keeps_the_sharded_fit(one_rank_group, table):
    """The hand-off keeps the sharded outcome's telemetry and config but
    the backend, and its stats on the local device."""
    km = serve.build_codebook(table, 16, 0, backend="mesh", device=CPU)
    assert km.outcome_.config.backend == "mesh"
    assert dataclasses.replace(km.config, backend="mesh") == \
        km.outcome_.config
    assert km.stats_.C.device.type == "cpu" and km.n_rounds_ > 0


def _prefill_recorder(module, seen: list, jitted: bool = False):
    """Wrap ``module.tstep.make_prefill_step`` so that ``seen`` gets each
    call's ``cache_len``, the batch, and the returned cache's ``pos`` and
    first K block as the prefill left them (the decode steps then write
    into the port's cache in place). ``jitted``: JAX's CLI jits the step,
    so these come out of the trace through a callback, as numpy."""
    real = module.tstep.make_prefill_step

    def make(cfg, *, cache_len):
        step = real(cfg, cache_len=cache_len)

        def run(params, batch):
            logits, cache = step(params, batch)
            if jitted:
                jax.debug.callback(lambda b, pos, k: seen.append(
                    {"cache_len": cache_len, "batch": b, "pos": int(pos),
                     "k": k}), batch, cache["pos"], cache["blocks"]["0"]["k"])
            else:
                seen.append({"cache_len": cache_len, "batch": batch,
                             "pos": int(cache["pos"]),
                             "k": cache["blocks"]["0"]["k"].clone()})
            return logits, cache
        return run
    return make


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-76b"])
def test_cli_serves_encdec_and_vlm_as_jax(arch, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch ARCH --device cpu --gen
    4`` (reduced, batch 4, prompt 32) in this process beside JAX's CLI:
    both print JAX's lines; both prefill with JAX's zero bf16 frames
    (whisper) or patches (internvl2); the cache is sized prompt + gen,
    and for the vlm its 8 patches before them (JAX's ``P + gen + n_ctx``):
    44 positions, 40 of them (prefix and prompt) filled by the
    prefill."""
    from repro.launch import serve as jserve
    jseen, seen = [], []
    monkeypatch.setattr(jserve.tstep, "make_prefill_step",
                        _prefill_recorder(jserve, jseen, jitted=True))
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch,
                                      "--reduced", "--gen", "4"])
    jserve.main()
    jout = capsys.readouterr().out
    monkeypatch.setattr(serve.tstep, "make_prefill_step",
                        _prefill_recorder(serve, seen))
    serve.main(["--arch", arch, "--device", "cpu", "--gen", "4"])
    out = capsys.readouterr().out
    cfg = configs.get_reduced(arch)
    prefix = cfg.encoder.n_ctx if cfg.family == "vlm" else 0
    line = (rf"{arch}: prefill 4x32 in [\d.]+ms; 3 decode steps in "
            rf"[\d.]+ms \(\d+ tok/s\)")
    assert re.search(line + r"\n", jout), jout
    assert re.search(line + r" on cpu\n", out), out
    for text in (jout, out):
        ids = json.loads(re.search(
            r"generated token ids \(row 0\): (\[.*\])", text).group(1))
        assert len(ids) == 4 and all(0 <= i < cfg.vocab for i in ids)
    assert len(seen) == len(jseen) == 1
    (got,), (want,) = seen, jseen
    assert got["cache_len"] == want["cache_len"] == 32 + 4 + prefix
    k = got["k"]
    assert tuple(k.shape) == want["k"].shape
    assert k.shape[2] == got["cache_len"]
    assert got["pos"] == want["pos"] == 32 + prefix
    assert bool(k[:, :, 32 + prefix - 1].any())
    assert not bool(k[:, :, 32 + prefix:].any())
    assert sorted(got["batch"]) == sorted(want["batch"])
    stub = "frames" if cfg.family == "encdec" else "patches"
    assert tuple(got["batch"][stub].shape) == want["batch"][stub].shape
    assert got["batch"][stub].dtype == torch.bfloat16
    assert str(want["batch"][stub].dtype) == "bfloat16"
    assert not bool(got["batch"][stub].any())
    assert not bool(np.asarray(want["batch"][stub]).any())

"""The port's mesh and multihost engines against the JAX package's mesh
engine, and against the port's own local fits, on the CPU.

* Placement: `ShardLayout`, `KMeansShardedSource` and
  `StoredShardSource` are array-equal to JAX's, including
  ``n % n_shards != 0``.
* One rank: a ``backend="mesh"`` fit over a one-rank gloo group and a
  one-process ``backend="multihost"`` fit (which joins its group from the
  coordinator fields) are bit-equal to the local fit.
* 2 and 4 gloo ranks, spawned by `torch.multiprocessing`
  (tests/torch_dist_worker.py, which imports no JAX), fit ``X[:3999]``
  (one structural pad) against JAX's mesh fit on as many forced host
  devices (tests/jax_mesh_oracle.py, in a subprocess, since this process
  must see one CPU device): the same schedule (b, n_recomputed,
  n_changed, grow), equal labels, every real row labelled, centroids at
  rtol 1e-5 (the two packages' products and sums add in other orders).
  The fit is tests/test_torch_fit.py's b0=1000 config, which has no
  Hamerly near-tie (ROADMAP Queue 3 item 1). The ranks hold the same
  bits.
* Bit for bit, within the port: the 2-rank multihost fit and the mesh
  fit; the store-backed mesh fit and the in-memory mesh fit of the rows
  in the store's order; a fit killed at round 10 and resumed on the same
  2 ranks and the unbroken fit. Across packages and shard counts, where
  the all-reduce adds in another order: a JAX 4-device checkpoint
  resumes on the port's 2 ranks with the port's 2-rank schedule, and a
  port 2-rank checkpoint on JAX's 4 devices with JAX's 4-device one.
* A mesh `partial_fit` stream matches the local stream's counts; the
  in-place check passes on each rank's buffer of a store-backed 2-rank
  fit; ``backend="xl"`` raises the JAX package's two `ValueError`s (the
  engine itself is tests/test_torch_xl.py's).
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch.distributed as dist

import torch_dist_worker as worker
from repro.data import pipeline as jpipe
from repro.data.store import StoredShardSource as JStoredShardSource
from repro_torch.api import FitConfig, NestedKMeans
from repro_torch.data import pipeline as tpipe
from repro_torch.data.store import StoredShardSource, write_store
from repro_torch.launch.mesh import make_host_mesh

N_FIT = 3999                     # 3999 % 2 and % 4 != 0: one pad row
ORACLE_TIMEOUT_S = 300
TESTS = Path(__file__).resolve().parent


# -- placement ----------------------------------------------------------------

LAYOUTS = [(100, 4, 0, True), (103, 4, 1, True), (7, 3, 2, False),
           (64, 1, 0, True), (11, 8, 3, True)]


@pytest.mark.parametrize("n,n_shards,seed,shuffle", LAYOUTS)
def test_layout_and_sources_match_jax(tmp_path, n, n_shards, seed, shuffle):
    want = jpipe.nested_shard_layout(n, n_shards, seed=seed, shuffle=shuffle)
    got = tpipe.nested_shard_layout(n, n_shards, seed=seed, shuffle=shuffle)
    for f in ("n_real", "n_shards", "n_storage", "rows_per_shard"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("perm", "pos", "n_valid"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.orig_index(), want.orig_index())
    X = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    jsrc = jpipe.KMeansShardedSource(X, n_shards, seed=seed)
    tsrc = tpipe.KMeansShardedSource(X, n_shards, seed=seed)
    write_store(tmp_path / "st", X, chunk_rows=16)
    jst = JStoredShardSource(tmp_path / "st", n_shards, seed=seed,
                             shuffle=shuffle)
    tst = StoredShardSource(tmp_path / "st", n_shards, seed=seed,
                            shuffle=shuffle)
    try:
        np.testing.assert_array_equal(tst.perm, jst.perm)
        for s in range(n_shards):
            np.testing.assert_array_equal(got.shard_positions(s),
                                          want.shard_positions(s))
            np.testing.assert_array_equal(got.shard_orig_rows(s),
                                          want.shard_orig_rows(s))
            assert tsrc.n_valid(s) == jsrc.n_valid(s) == tst.n_valid(s)
            np.testing.assert_array_equal(tsrc.shard(s), jsrc.shard(s))
            np.testing.assert_array_equal(tsrc.shard_valid(s),
                                          jsrc.shard_valid(s))
            np.testing.assert_array_equal(tst.shard(s), jst.shard(s))
            np.testing.assert_array_equal(tst.shard_valid(s),
                                          jst.shard_valid(s))
        np.testing.assert_array_equal(tsrc.global_prefix(n // 2),
                                      jsrc.global_prefix(n // 2))
        np.testing.assert_array_equal(tst.global_prefix(n // 2),
                                      jst.global_prefix(n // 2))
        shards = np.arange(n_shards)[::-1]
        hi = got.rows_per_shard
        np.testing.assert_array_equal(tst.block(shards, 1, hi),
                                      jst.block(shards, 1, hi))
    finally:
        jst.close()
        tst.close()


# -- one rank -----------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tel(km):
    return [{k: v for k, v in r.to_dict().items() if k != "t"}
            for r in km.telemetry_]


def _same(got, want):
    np.testing.assert_array_equal(got.cluster_centers_, want.cluster_centers_)
    np.testing.assert_array_equal(got.labels_, want.labels_)
    assert _tel(got) == _tel(want)


@pytest.mark.parametrize("bounds", worker.BOUNDS)
def test_one_rank_mesh_and_multihost_equal_local(blobs, blobs_val, bounds):
    """The multihost fit joins a one-rank gloo group from its coordinator
    fields (a localhost port), and the mesh fit runs over that group."""
    X = blobs[0][:N_FIT]
    kw = dict(worker.FIT, bounds=bounds)
    local = NestedKMeans(FitConfig(**kw), device="cpu").fit(X, X_val=blobs_val)
    assert not dist.is_initialized()
    cfg = FitConfig(backend="multihost", coordinator_address=(
        f"localhost:{_free_port()}"), num_processes=1, process_id=0, **kw)
    try:
        multi = NestedKMeans(cfg, device="cpu").fit(X, X_val=blobs_val)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = NestedKMeans(FitConfig(backend="mesh", **kw),
                            mesh=make_host_mesh((1,), ("data",)),
                            device="cpu").fit(X, X_val=blobs_val)
    finally:
        dist.destroy_process_group()
    for km in (multi, mesh):
        _same(km, local)
        np.testing.assert_array_equal(km.predict(X), local.predict(X))


def test_fit_distributed_shim_matches_jax(blobs):
    """The deprecated entry point over a one-rank gloo group against
    JAX's on a one-device mesh: the dict telemetry's schedule, the
    algorithm's name and the centroids (rtol 1e-5)."""
    from repro.core.distributed import fit_distributed as jfit
    from repro_torch.core.distributed import fit_distributed
    X = blobs[0][:N_FIT]
    want = jfit(X, 8, jax.make_mesh((1,), ("data",)), b0=1000)
    dist.init_process_group("gloo", init_method=(
        f"tcp://localhost:{_free_port()}"), world_size=1, rank=0)
    try:
        got = fit_distributed(X, 8, make_host_mesh((1,), ("data",)),
                              b0=1000, device="cpu")
    finally:
        dist.destroy_process_group()
    keys = ("b", "n_recomputed", "n_changed", "grow")
    assert [[r[k] for k in keys] for r in got.telemetry] == \
        [[r[k] for k in keys] for r in want.telemetry]
    assert got.algorithm == want.algorithm == "tb-dist[hamerly2]"
    assert got.converged == want.converged
    np.testing.assert_allclose(got.C, np.asarray(want.C), rtol=1e-5,
                               atol=1e-5)


class _Ranks:
    """A stand-in for a `DeviceMesh`: its named dims and this rank's
    coordinates."""

    def __init__(self, shape, names, coord):
        self.shape, self.mesh_dim_names, self._coord = shape, names, coord

    def get_local_rank(self, axis):
        return self._coord[self.mesh_dim_names.index(axis)]


def test_shard_state_takes_this_ranks_rows():
    """Row-major over the data dims (JAX's ``P(data_axes)`` slices),
    replicated over "model"; the stats and the round are shared and the
    elkan bounds dropped, as in JAX."""
    import torch

    from repro_torch.core.distributed import shard_state
    from repro_torch.core.state import init_state
    X = torch.arange(24 * 2, dtype=torch.float32).reshape(24, 2)
    full = init_state(X, 3, bounds="elkan")
    full.points.a[:] = torch.arange(24, dtype=torch.int32)
    for p in range(2):
        for q in range(3):
            for m in range(2):
                mesh = _Ranks((2, 3, 2), ("pod", "data", "model"), (p, q, m))
                got = shard_state(full, mesh, ("pod", "data"))
                lo = (p * 3 + q) * 4
                assert got.points.a.tolist() == list(range(lo, lo + 4))
                assert got.points.d.shape == got.points.lb.shape == (4,)
                assert got.stats is full.stats and got.elkan is None
    with pytest.raises(ValueError, match="divide"):
        shard_state(init_state(X[:23], 3), _Ranks((2,), ("data",), (0,)),
                    ("data",))


def test_xl_is_refused_and_mesh_needs_a_mesh():
    """xl raises the JAX package's two `ValueError`s: a mesh without the
    model dim (a one-rank gloo group's (1,) data mesh), and k = 4 over 3
    model ranks (a stand-in for a (1, 3) mesh, which one rank cannot
    build). Without a mesh, xl, like mesh, asks for one."""
    from repro_torch.api.engines.xl import _XLRun
    X = np.zeros((8, 2), np.float32)
    dist.init_process_group("gloo", init_method=(
        f"tcp://localhost:{_free_port()}"), world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="needs mesh axis 'model'"):
            NestedKMeans(FitConfig(k=4, backend="xl"),
                         mesh=make_host_mesh((1,), ("data",)),
                         device="cpu").fit(X)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="must divide evenly"):
        _XLRun(X, FitConfig(k=4, backend="xl").resolve(8),
               _Ranks((1, 3), ("data", "model"), (0, 0)), None, None, "cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        NestedKMeans(FitConfig(k=4, backend="xl"), device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        NestedKMeans(FitConfig(k=4, backend="mesh"), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        NestedKMeans(FitConfig(k=4, backend="multihost"),
                     device="cpu").fit(np.zeros((8, 2), np.float32))


# -- 2 and 4 gloo ranks against JAX's mesh on forced devices ------------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory, blobs, blobs_val):
    """The fit's rows, a chunk store of them (512-row chunks) and room
    for the checkpoints, shared by the spawns and the JAX oracle."""
    wd = tmp_path_factory.mktemp("mesh")
    X = blobs[0][:N_FIT]
    np.savez(wd / "inputs.npz", X=X, Xv=blobs_val)
    write_store(wd / "store", X, chunk_rows=512)
    return wd


def _ranks(tmp_path_factory, workdir, world, parts):
    d = tmp_path_factory.mktemp(f"ranks{world}")
    inp = dict(np.load(workdir / "inputs.npz"))
    return worker.spawn(d, "mesh", (world,), ("data",), parts=parts,
                        dir=str(workdir), **inp)


@pytest.fixture(scope="module")
def two(tmp_path_factory, workdir):
    """Two ranks: the fits, the 2-rank multihost fit, the store fit,
    kill-and-resume (leaving the killed checkpoint in ``port_ck``),
    partial_fit and the in-place check."""
    return _ranks(tmp_path_factory, workdir, 2,
                  ["fits", "multihost", "store", "resume", "partial",
                   "inplace"])


@pytest.fixture(scope="module")
def four(tmp_path_factory, workdir):
    return _ranks(tmp_path_factory, workdir, 4, ["fits"])


@pytest.fixture(scope="module")
def oracle(workdir, two):
    """JAX's mesh fits on 2 and 4 forced devices, its killed 4-device
    checkpoint (``jax_ck``) and its resume of ``port_ck``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(TESTS.parent / "src"), str(TESTS)]))
    r = subprocess.run([sys.executable, str(TESTS / "jax_mesh_oracle.py"),
                        str(workdir)], env=env, capture_output=True,
                       text=True, timeout=ORACLE_TIMEOUT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(workdir / "jax.npz"))


@pytest.fixture(scope="module")
def two_from_jax(tmp_path_factory, workdir, oracle):
    return _ranks(tmp_path_factory, workdir, 2, ["resume_jax"])


def _replicated(ranks, key):
    """The value every rank holds, the same bits on each."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


@pytest.mark.parametrize("world,bounds", [(w, b) for w in (2, 4)
                                          for b in worker.BOUNDS])
def test_rank_fit_matches_jax_mesh(request, oracle, world, bounds):
    ranks = request.getfixturevalue({2: "two", 4: "four"}[world])
    tag = f"{bounds}_{world}"
    labels = _replicated(ranks, f"labels_{bounds}")
    C = _replicated(ranks, f"C_{bounds}")
    sched = _replicated(ranks, f"sched_{bounds}")
    np.testing.assert_array_equal(sched, oracle[f"sched_{tag}"])
    np.testing.assert_array_equal(labels, oracle[f"labels_{tag}"])
    assert labels.shape == (N_FIT,) and labels.min() >= 0
    assert sched[-1, 0] == N_FIT          # n_active: every real row
    np.testing.assert_allclose(C, oracle[f"C_{tag}"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_replicated(ranks, f"val_{bounds}"),
                               oracle[f"val_{tag}"], rtol=1e-5)
    # each rank holds its own shard's rows only
    assert {int(r["rows"]) for r in ranks} == {-(-N_FIT // world)}


def test_two_rank_multihost_equals_mesh(two):
    for key in ("C", "labels", "tel"):
        np.testing.assert_array_equal(
            _replicated(two, f"{key}_multihost"),
            _replicated(two, f"{key}_hamerly2"))


def test_store_mesh_fit_equals_in_memory_fit(two, workdir):
    from repro_torch.data.store import ChunkStore, store_permutation
    with ChunkStore(workdir / "store") as st:
        perm = store_permutation(st.n, st.chunk_rows, worker.FIT["seed"])
    np.testing.assert_array_equal(_replicated(two, "C_store"),
                                  _replicated(two, "C_permuted"))
    np.testing.assert_array_equal(_replicated(two, "labels_store")[perm],
                                  _replicated(two, "labels_permuted"))
    assert _replicated(two, "tel_store") == _replicated(two, "tel_permuted")


def _saved_t(ck):
    """The work clock of the records saved in a killed fit's last
    checkpoint (round 8): a resumed fit starts from these."""
    from repro_torch.checkpoint import CheckpointStore
    st = CheckpointStore(ck)
    step = st.latest_step()
    assert step == worker.KILL_ROUND // worker.SAVE_EVERY * worker.SAVE_EVERY
    return [r["t"] for r in st.read_extra(step)["telemetry"]]


def _restored(t, ck):
    saved = _saved_t(ck)
    assert list(t[:len(saved)]) == saved, "the fit did not restore"
    assert len(t) > worker.KILL_ROUND


def test_kill_and_resume_on_the_same_ranks_is_bitwise(two, workdir):
    for key in ("C", "labels", "tel"):
        np.testing.assert_array_equal(_replicated(two, f"{key}_resumed"),
                                      _replicated(two, f"{key}_hamerly2"))
    _restored(two[0]["t_resumed"], workdir / "port_ck")


def test_checkpoints_move_between_the_packages_and_shard_counts(
        two, oracle, two_from_jax, workdir):
    """JAX's 4-device checkpoint at round 8 resumes on the port's 2 ranks
    with the port's 2-rank schedule, and the port's 2-rank one on JAX's 4
    devices with JAX's 4-device schedule (the two part at round 15)."""
    _restored(two_from_jax[0]["t_resumed_jax"], workdir / "jax_ck")
    _restored(oracle["resumed_t"], workdir / "port_ck")
    np.testing.assert_array_equal(
        _replicated(two_from_jax, "sched_resumed_jax"),
        _replicated(two, "sched_hamerly2"))
    np.testing.assert_array_equal(
        _replicated(two_from_jax, "labels_resumed_jax"),
        _replicated(two, "labels_hamerly2"))
    np.testing.assert_allclose(_replicated(two_from_jax, "C_resumed_jax"),
                               _replicated(two, "C_hamerly2"),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(oracle["resumed_sched"],
                                  oracle["sched_hamerly2_4"])
    np.testing.assert_array_equal(oracle["resumed_labels"],
                                  oracle["labels_hamerly2_4"])
    np.testing.assert_allclose(oracle["resumed_C"], oracle["C_hamerly2_4"],
                               rtol=1e-5, atol=1e-5)


def test_mesh_partial_fit_matches_the_local_stream(two, blobs):
    """The port's form of tests/test_api.py::test_partial_fit_runs_sharded:
    the same counts, the batch's rows in the last record, centroids at
    atol 1e-3 (the sharded stream shuffles the batch, so its sums add in
    another order)."""
    X = blobs[0]
    km = NestedKMeans(FitConfig(**worker.FIT), device="cpu")
    km.fit(X[:worker.PARTIAL_FIT])
    for lo, hi in worker.PARTIAL_BATCHES:
        km.partial_fit(X[lo:hi])
    counts = _replicated(two, "partial_counts")
    assert counts.sum() == km.counts_.sum() == 3048
    assert int(_replicated(two, "partial_b")) == km.telemetry_[-1].b == 500
    np.testing.assert_allclose(_replicated(two, "partial_C"),
                               km.cluster_centers_, atol=1e-3)


def test_inplace_check_passes_on_each_rank(two):
    for r in two:
        assert list(r["inplace"]) == []

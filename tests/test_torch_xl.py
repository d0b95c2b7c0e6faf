"""The port's XL engine (centroids sharded over a model dim) against the
JAX package's XL engine, and against the port's own local and mesh fits,
on the CPU.

The chains of scripts/smoke_xl.py (stages 1-5) and scripts/smoke_bounds.py's
xl parts, held inside the port on gloo ranks spawned by
`torch.multiprocessing` (tests/torch_dist_worker.py's ``xl_engine`` case,
which imports no JAX), against JAX's XL engine on as many forced host
devices (tests/jax_xl_oracle.py, in a subprocess, since this process must
see one CPU device):

* units on (1, 2), (2, 2) and (1, 4) ("data", "model") groups: the
  distance to the assigned centroid, the ring's s/2 table and the
  exponion geometry on integer inputs (every sum exact, so bit-equal to
  JAX and to the port's dense helpers), the row chunks, the (min, argmin)
  fold with a cross-shard exact tie, and one `xl_nested_round` of each
  bound family (hamerly2 also compacted) from the same mid-fit JAX state
  with the S/v and sse deltas: labels and the integer `RoundInfo` fields
  equal, floats at rtol 1e-5 (the packages' products add in other
  orders);
* fits: a one-rank XL fit bit-equal to the local fit (every family), a
  (2, 1) XL fit to the 2-rank mesh fit; (2, 2) fits of ``X[:3999]`` (one
  structural pad) against JAX's XL(2, 2) as tests/test_torch_mesh.py
  holds the mesh (the blobs at b0=1000, which have no Hamerly near-tie,
  ROADMAP Queue 3 item 1); a (1, 4) exponion fit at k = 8, whose rings
  are degenerate (k_local = 2); rho = 0.5 reaching the growth controller
  and ``bounds="none"`` sharded;
* checkpoints: XL kill-and-resume on the same ranks bit for bit; a JAX
  XL(2, 2) checkpoint resumed on the port's (2, 2) ranks and a port XL
  one on JAX's XL engine; XL to local and local to XL restores converge
  to the local fit's quality;
* `partial_fit` on ``backend="xl"`` against the local stream, and the
  in-place check on each rank's store buffer.
"""
import dataclasses
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as worker
from repro.core import distributed_xl as jdxl
from repro.core import rounds as jrounds
from repro.core import state as jstate
from repro.kernels.plan import resolve_plan as jresolve
from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans
from repro_torch.core import distributed_xl as dxl
from repro_torch.core import rounds as trounds
from repro_torch.core import state as tstate
from repro_torch.data.store import write_store
from repro_torch.launch.mesh import make_host_mesh

N_FIT = 3999                     # 3999 % 2 != 0: one pad row on (2, 2)
ORACLE_TIMEOUT_S = 300
TESTS = Path(__file__).resolve().parent
SHAPES = ("1x2", "2x2", "1x4")
INFO_INTS = ("n_changed", "n_recomputed", "n_active", "overflow", "grow")
INFO_FLOATS = ("batch_mse", "r_median", "p_max")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _tel(km):
    return [{k: v for k, v in r.to_dict().items() if k != "t"}
            for r in km.telemetry_]


def _replicated(ranks, key):
    """The value every rank holds, the same bits on each."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key])
    return ranks[0][key]


def _local(X, Xv, **kw):
    return NestedKMeans(FitConfig(**dict(worker.FIT, **kw)),
                        device="cpu").fit(X, X_val=Xv)


# -- fixtures: the inputs, JAX's oracle and the two spawned groups ------------

@pytest.fixture(scope="module")
def workdir(tmp_path_factory, blobs, blobs_val):
    """The fit's rows, the mid-fit JAX states of the unit rounds (the
    shuffled blobs two b=1000 rounds in, as tests/test_torch_bounds.py
    makes them), a chunk store of the rows (512-row chunks) and a local
    checkpoint killed at round 10 (``local_ck``)."""
    wd = tmp_path_factory.mktemp("xl")
    X = blobs[0][:N_FIT]
    Xmid = blobs[0][np.random.default_rng(0).permutation(len(blobs[0]))]
    inp = dict(X=X, Xv=blobs_val, Xmid=Xmid)
    plan = jresolve("ref", b=len(Xmid), k=8, d=Xmid.shape[1])
    for fam in worker.XL_FAMILIES:
        st = jstate.init_state(jnp.asarray(Xmid), 8, bounds=fam)
        for _ in range(2):
            st, _ = jrounds.nested_round(jnp.asarray(Xmid), st, b=1000,
                                         rho=np.inf, bounds=fam, plan=plan)
        leaves = dict(C=st.stats.C, S=st.stats.S, v=st.stats.v,
                      sse=st.stats.sse, p=st.stats.p, a=st.points.a,
                      d=st.points.d, lb=st.points.lb, round=st.round)
        if st.elkan is not None:
            leaves["l"] = st.elkan.l
        inp.update({f"mid_{fam}_{f}": np.asarray(v)
                    for f, v in leaves.items()})
    np.savez(wd / "inputs.npz", **inp)
    write_store(wd / "store", X, chunk_rows=512)
    cfg = FitConfig(checkpoint=CheckpointConfig(
        checkpoint_dir=str(wd / "local_ck"),
        save_every=worker.SAVE_EVERY), **worker.FIT)
    with pytest.raises(worker.Killed):
        NestedKMeans(cfg, device="cpu", on_round=worker.kill_at).fit(
            X, X_val=blobs_val)
    return wd


@pytest.fixture(scope="module")
def oracle(workdir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(TESTS.parent / "src"), str(TESTS)]))
    r = subprocess.run([sys.executable, str(TESTS / "jax_xl_oracle.py"),
                        str(workdir)], env=env, capture_output=True,
                       text=True, timeout=ORACLE_TIMEOUT_S)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(workdir / "jax_xl.npz"))


def _ranks(tmp_path_factory, workdir, shape, parts):
    d = tmp_path_factory.mktemp("xl_ranks")
    inp = dict(np.load(workdir / "inputs.npz"))
    return worker.spawn(d, "xl_engine", shape, worker.XL_AXES, parts=parts,
                        dir=str(workdir), **inp)


@pytest.fixture(scope="module")
def two(tmp_path_factory, workdir):
    """Two ranks: the units on (1, 2) and the (2, 1) XL and mesh fits."""
    return _ranks(tmp_path_factory, workdir, (1, 2),
                  ["units:1x2", "mesh_equal:2x1"])


@pytest.fixture(scope="module")
def four(tmp_path_factory, workdir, oracle):
    """Four ranks: the units on (2, 2) and (1, 4), the (2, 2) fits, the
    none and exponion fits on (2, 2) and (1, 4), growth, kill-and-resume,
    the JAX and local checkpoints resumed, partial_fit and the in-place
    check."""
    return _ranks(tmp_path_factory, workdir, (2, 2),
                  ["units:2x2", "units:1x4", "fits:2x2", "families:2x2",
                   "families:1x4", "growth:2x2", "resume:2x2",
                   "resume_jax:2x2", "resume_local:2x2", "partial:2x2",
                   "inplace:2x2"])


def _group(request, tag):
    return request.getfixturevalue("two" if tag == "1x2" else "four")


# -- units --------------------------------------------------------------------

@pytest.mark.parametrize("tag", SHAPES)
def test_sharded_helpers_are_exact(request, oracle, tag):
    """Bit-equal to JAX's and to the port's dense helpers, on integer
    inputs (every product and sum exact); the row chunks are JAX's."""
    ranks = _group(request, tag)
    x, C, a = (torch.from_numpy(t) for t in worker.xl_int_inputs())
    for key in ("dist", "half", "B", "s"):
        np.testing.assert_array_equal(_replicated(ranks, f"{tag}_{key}"),
                                      oracle[f"{tag}_{key}"], err_msg=key)
    seen = (a >= 0).numpy()
    np.testing.assert_array_equal(
        ranks[0][f"{tag}_dist"][seen],
        trounds._dist_to_assigned(x, C, a).numpy()[seen])
    np.testing.assert_array_equal(ranks[0][f"{tag}_half"],
                                  trounds._half_intercentroid(C).numpy())
    geom = tstate.build_exponion_geom(C)
    np.testing.assert_array_equal(ranks[0][f"{tag}_s"], geom.s.numpy())
    chunks = np.concatenate([r[f"{tag}_chunk"] for r in ranks])
    np.testing.assert_array_equal(chunks, oracle[f"{tag}_chunk"])


@pytest.mark.parametrize("tag", SHAPES)
@pytest.mark.parametrize("name", [r[0] for r in worker.XL_ROUNDS])
def test_xl_round_matches_jax(request, oracle, tag, name):
    """One round from the same mid-fit JAX state: labels and the integer
    info equal; the stats, distances, bounds and deltas at rtol 1e-5."""
    ranks = _group(request, tag)
    key = f"{tag}_{name}"
    np.testing.assert_array_equal(_replicated(ranks, f"{key}_a"),
                                  oracle[f"{key}_a"])
    for f in INFO_INTS:
        assert int(_replicated(ranks, f"{key}_info_{f}")) == \
            int(oracle[f"{key}_info_{f}"]), f
    for f in INFO_FLOATS:
        np.testing.assert_allclose(_replicated(ranks, f"{key}_info_{f}"),
                                   oracle[f"{key}_info_{f}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    for f in ("C", "S", "v", "p", "dS", "dv"):
        np.testing.assert_allclose(_replicated(ranks, f"{key}_{f}"),
                                   oracle[f"{key}_{f}"], rtol=1e-5,
                                   atol=1e-5, err_msg=f)
    for f in ("sse", "dsse"):
        np.testing.assert_allclose(_replicated(ranks, f"{key}_{f}"),
                                   oracle[f"{key}_{f}"], rtol=1e-5,
                                   atol=1e-3, err_msg=f)
    for f in ("d", "lb") + (("l",) if name == "elkan" else ()):
        np.testing.assert_allclose(_replicated(ranks, f"{key}_{f}"),
                                   oracle[f"{key}_{f}"], atol=1e-4,
                                   err_msg=f)


@pytest.mark.parametrize("tag", SHAPES)
def test_cross_shard_exact_tie_goes_to_the_lower_index(request, tag):
    """Rows on centroids 1 and 6, exact copies in different k-slices,
    take 1 in every family, as an argmin over the unsharded row does."""
    ranks = _group(request, tag)
    for fam in worker.XL_FAMILIES:
        assert _replicated(ranks, f"{tag}_tie_{fam}").tolist() == \
            [1, 1, 2, 0], fam


def test_fold_min_idx_matches_jax():
    rng = np.random.default_rng(3)
    da, db = (rng.integers(0, 4, 64).astype(np.float32) for _ in range(2))
    ia, ib = (rng.integers(0, 16, 64).astype(np.int32) for _ in range(2))
    want = jdxl._fold_min_idx(*(jnp.asarray(t) for t in (da, ia, db, ib)))
    got = dxl._fold_min_idx(*(torch.from_numpy(t)
                              for t in (da, ia, db, ib)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    tie = da == db
    assert tie.any()
    assert (got[1].numpy()[tie] == np.minimum(ia, ib)[tie]).all()


def test_one_rank_collectives_are_identities_without_a_call(monkeypatch):
    """Over dims of one rank every collective gives its input back, as
    over a one-device JAX mesh, and calls no backend."""
    from repro_torch.core import collectives

    def refuse(*a, **kw):
        raise AssertionError("a one-rank collective called the backend")

    dist.init_process_group("gloo", init_method=(
        f"tcp://localhost:{_free_port()}"), world_size=1, rank=0)
    try:
        mesh = make_host_mesh((1, 1), worker.XL_AXES)
        for name in ("all_reduce", "all_gather", "reduce_scatter_tensor",
                     "all_to_all_single"):
            monkeypatch.setattr(dist, name, refuse)
        t = torch.randn(6, 3, generator=torch.Generator().manual_seed(0))
        n = torch.tensor([3, 4], dtype=torch.int32)
        flag = torch.tensor(True)
        got = collectives.psum((t, n, flag), mesh, ("data", "model"))
        assert all(torch.equal(g, w) and g.dtype == w.dtype
                   for g, w in zip(got, (t, n, flag)))
        for fn in (collectives.psum_scatter, collectives.pmax,
                   collectives.pmin, collectives.ppermute_ring):
            assert torch.equal(fn(t, mesh, "model"), t), fn.__name__
        assert torch.equal(collectives.all_gather(t, mesh, "model"), t[None])
        assert torch.equal(collectives.gather_rows(t, mesh, ("data",)), t)
    finally:
        monkeypatch.undo()
        dist.destroy_process_group()


# -- fits ---------------------------------------------------------------------

@pytest.mark.parametrize("bounds", worker.XL_FAMILIES)
def test_one_rank_xl_equals_local(blobs, blobs_val, bounds):
    """A (1, 1) XL fit over a one-rank gloo group: C, labels, telemetry
    (but t), the points' distances and bounds, and predict bit-equal to
    the local fit's."""
    X = blobs[0][:N_FIT]
    local = _local(X, blobs_val, bounds=bounds)
    dist.init_process_group("gloo", init_method=(
        f"tcp://localhost:{_free_port()}"), world_size=1, rank=0)
    try:
        km = NestedKMeans(FitConfig(**dict(worker.FIT, backend="xl",
                                           bounds=bounds)),
                          mesh=make_host_mesh((1, 1), worker.XL_AXES),
                          device="cpu").fit(X, X_val=blobs_val)
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(km.cluster_centers_,
                                  local.cluster_centers_)
    np.testing.assert_array_equal(km.labels_, local.labels_)
    assert _tel(km) == _tel(local)
    np.testing.assert_array_equal(km.predict(X), local.predict(X))
    for f in ("d", "lb"):
        assert torch.equal(getattr(km.outcome_.state.points, f),
                           getattr(local.outcome_.state.points, f)), f


def test_xl_2x1_equals_the_mesh_fit(two):
    for key in ("C", "labels", "tel"):
        np.testing.assert_array_equal(_replicated(two, f"{key}_2x1_xl"),
                                      _replicated(two, f"{key}_2x1_mesh"))


@pytest.mark.parametrize("bounds", worker.XL_BOUNDS)
def test_xl_2x2_fit_matches_jax(four, oracle, bounds):
    tag = f"2x2_{bounds}"
    labels = _replicated(four, f"labels_{tag}")
    sched = _replicated(four, f"sched_{tag}")
    np.testing.assert_array_equal(sched, oracle[f"sched_{tag}"])
    np.testing.assert_array_equal(labels, oracle[f"labels_{tag}"])
    assert labels.shape == (N_FIT,) and labels.min() >= 0
    assert sched[-1, 0] == N_FIT          # n_active: every real row
    np.testing.assert_allclose(_replicated(four, f"C_{tag}"),
                               oracle[f"C_{tag}"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_replicated(four, f"val_{tag}"),
                               oracle[f"val_{tag}"], rtol=1e-5)
    # each data rank holds its own shard's rows only
    assert {int(r["2x2_rows"]) for r in four} == {-(-N_FIT // 2)}


@pytest.mark.parametrize("tag", ["2x2", "1x4"])
def test_exponion_equals_none_sharded(four, tag):
    """scripts/smoke_bounds.py's family parity on the XL engine: the
    exponion fit's labels and centroids bit-equal to the ``bounds="none"``
    fit's on the same ranks, every real row labelled. On (1, 4), k = 8
    leaves 2 columns a rank: the rings are degenerate and fall back to
    the full local scan, which counts more pairs."""
    for key in ("labels", "C"):
        np.testing.assert_array_equal(
            _replicated(four, f"{key}_{tag}_exponion"),
            _replicated(four, f"{key}_{tag}_none"))
    labels = _replicated(four, f"labels_{tag}_none")
    assert labels.shape == (N_FIT,) and labels.min() >= 0
    assert _replicated(four, f"sched_{tag}_none")[-1, 0] == N_FIT
    ex = _replicated(four, f"sched_{tag}_exponion")
    assert ex[:, 1].sum() < N_FIT * 8 * len(ex)


def test_rho_reaches_the_controller(four):
    sched = _replicated(four, "sched_2x2_rho")
    assert sched[:, 3].any(), "rho=0.5 never reached the controller"


# -- checkpoints --------------------------------------------------------------

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


def test_xl_kill_and_resume_is_bitwise(four, workdir):
    for key in ("C", "labels", "tel"):
        np.testing.assert_array_equal(
            _replicated(four, f"{key}_2x2_resumed"),
            _replicated(four, f"{key}_2x2_hamerly2"))
    _restored(four[0]["t_2x2_resumed"], workdir / "port_xl_ck2x2")


def test_xl_checkpoints_move_between_the_packages(four, workdir,
                                                  blobs_val):
    """JAX's XL(2, 2) checkpoint at round 8 resumes on the port's (2, 2)
    ranks with the port's schedule and labels; the port's XL(2, 2)
    checkpoint resumes on JAX's XL engine, on one device, as JAX's own
    XL(2, 2) checkpoint does: the same schedule and labels, C at rtol
    1e-5. (Across shard counts the capacity bucket restarts, so that
    schedule parts from JAX's unbroken one-device fit at round 9.)"""
    from repro.api import CheckpointConfig as JCk
    from repro.api import FitConfig as JConfig
    from repro.api import NestedKMeans as JKMeans
    _restored(four[0]["t_2x2_resumed_jax"], workdir / "jax_xl_ck")
    for key in ("sched", "labels"):
        np.testing.assert_array_equal(
            _replicated(four, f"{key}_2x2_resumed_jax"),
            _replicated(four, f"{key}_2x2_hamerly2"))
    np.testing.assert_allclose(_replicated(four, "C_2x2_resumed_jax"),
                               _replicated(four, "C_2x2_hamerly2"),
                               rtol=1e-5, atol=1e-5)
    X = np.load(workdir / "inputs.npz")["X"]
    mesh = jax.make_mesh((1, 1), worker.XL_AXES)
    ck = workdir / "port_xl_ck2x2_jax"
    shutil.copytree(workdir / "port_xl_ck2x2", ck)
    shutil.copytree(workdir / "jax_xl_ck", workdir / "jax_xl_ck_jax")
    cfg = JConfig(backend="xl", kernel_backend="ref", **worker.FIT)
    got, want = (JKMeans(dataclasses.replace(cfg, checkpoint=JCk(
        checkpoint_dir=str(d), save_every=worker.SAVE_EVERY)),
        mesh=mesh).fit(X, X_val=blobs_val, resume=True)
        for d in (ck, workdir / "jax_xl_ck_jax"))
    _restored([r.t for r in got.telemetry_], workdir / "port_xl_ck2x2")
    np.testing.assert_array_equal(worker.schedule(got),
                                  worker.schedule(want))
    np.testing.assert_array_equal(got.labels_, want.labels_)
    np.testing.assert_allclose(got.cluster_centers_, want.cluster_centers_,
                               rtol=1e-5, atol=1e-5)


def test_xl_and_local_restores_converge(four, workdir, blobs, blobs_val):
    """XL(2, 2) -> local and local -> XL(2, 2): each resumed fit
    converges, labels every row, and reaches the local fit's validation
    MSE within 1e-4 relative."""
    X = blobs[0][:N_FIT]
    local = _local(X, blobs_val)
    # the resumed fit goes on saving: into a copy
    shutil.copytree(workdir / "port_xl_ck2x2", workdir / "port_xl_ck_local")
    ck = CheckpointConfig(checkpoint_dir=str(workdir / "port_xl_ck_local"),
                          save_every=worker.SAVE_EVERY)
    km = NestedKMeans(FitConfig(checkpoint=ck, **worker.FIT),
                      device="cpu").fit(X, X_val=blobs_val, resume=True)
    _restored([r.t for r in km.telemetry_], workdir / "port_xl_ck2x2")
    vals = {"xl->local": (km.converged_, km.labels_.min(), km.final_mse_),
            "local->xl": (True, _replicated(four, "labels_2x2_resumed_local")
                          .min(), float(_replicated(
                              four, "val_2x2_resumed_local")))}
    _restored(four[0]["t_2x2_resumed_local"], workdir / "local_ck")
    for what, (converged, lo, val) in vals.items():
        assert converged and lo >= 0, what
        assert abs(val - local.final_mse_) <= 1e-4 * local.final_mse_, what


# -- streaming and the in-place check -----------------------------------------

def test_xl_partial_fit_matches_the_local_stream(four, blobs):
    """The counts and the last record's batch size equal the local
    stream's; centroids at atol 1e-3 (the sharded stream shuffles the
    batch, so its sums add in another order)."""
    X = blobs[0]
    km = NestedKMeans(FitConfig(**worker.FIT), device="cpu")
    km.fit(X[:worker.PARTIAL_FIT])
    for lo, hi in worker.PARTIAL_BATCHES:
        km.partial_fit(X[lo:hi])
    counts = _replicated(four, "2x2_partial_counts")
    assert counts.sum() == km.counts_.sum() == 3048
    assert int(_replicated(four, "2x2_partial_b")) == \
        km.telemetry_[-1].b == 500
    np.testing.assert_allclose(_replicated(four, "2x2_partial_C"),
                               km.cluster_centers_, atol=1e-3)


def test_xl_inplace_check_passes_on_each_rank(four):
    for r in four:
        assert list(r["2x2_inplace"]) == []


@pytest.mark.parametrize("path", ["src/repro_torch/api/engines/xl.py",
                                  "src/repro_torch/core/distributed_xl.py"])
def test_replicated_lint_passes_on_the_xl_modules(path):
    """No branch, host coercion or RNG draw that a rank could take
    alone, and no allowlist entry for it."""
    from repro_torch.analysis import replicated_lint
    assert replicated_lint.lint_file(TESTS.parent / path,
                                     mode="engine") == []

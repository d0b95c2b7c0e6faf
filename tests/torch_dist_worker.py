"""One rank of a gloo process group on the CPU, for
tests/test_torch_distributed.py and tests/test_torch_mesh.py.

The test spawns ``world`` ranks of `run` with
``torch.multiprocessing.start_processes(..., start_method="spawn")``. Each
rank joins the group through a `FileStore` file, builds the mesh, runs one
case on its shard of the inputs the test wrote to ``inputs.npz`` (the
round cases), or fits the whole of them through the mesh engines (the
``mesh`` case, whose parts the test names in ``inputs.npz``) or through
the serve launcher's `build_codebook` (the ``codebook`` case), sums
int8-compressed gradients (the ``compress`` case), runs the sharded
LM train step (the ``sharded_train`` case, `SHARDED_CELLS`) or the
sharded prefill and decode (the ``sharded_serve`` case, `SERVE_CELLS`),
and writes its outputs to ``rank<r>.npz`` beside it. This module imports
no JAX:
only torch, numpy and the port. tests/jax_mesh_oracle.py reads the fit's
config and the kill schedule from here.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import math
import shutil
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.ranks import spawn_and_join
from repro_torch.core import collectives, distributed, state as tstate
from repro_torch.launch.mesh import make_host_mesh


DP_OUT = ("C_new", "S", "v", "a", "d", "grow", "r_med", "mse")


def _np(t):
    return t.detach().cpu().numpy()


def _rows(X, mesh, axes):
    """This rank's contiguous slice of X, row-major over ``axes``."""
    n_shards = math.prod(collectives.axis_size(mesh, ax) for ax in axes)
    per = X.shape[0] // n_shards
    i = collectives.linear_index(mesh, axes)
    return X[i * per:(i + 1) * per]


def _dp(mesh, inp):
    X, C = torch.from_numpy(inp["X"]), torch.from_numpy(inp["C"])
    x = _rows(X, mesh, mesh.mesh_dim_names)
    out = {}
    for fused in (True, False):
        res = distributed.make_dp_round(mesh, fused=fused)(x, C)
        for name, t in zip(DP_OUT, res):
            out[f"{name}_{int(fused)}"] = _np(t)
    return out


def _xl(mesh, inp):
    X, C = torch.from_numpy(inp["X"]), torch.from_numpy(inp["C"])
    k = C.shape[0]
    x = _rows(X, mesh, ("data",))
    C_local = _rows(C, mesh, ("model",))
    res = distributed.make_xl_round(mesh, k=k)(
        x, C_local, torch.zeros_like(C_local),
        torch.zeros(C_local.shape[0]))
    out = {name: _np(t) for name, t in zip(
        ("C", "S", "v", "a", "d", "d2", "grow", "r_med", "mse"), res)}
    # all_gather returns the ranks of a dim in coordinate order
    out["model_order"] = _np(collectives.all_gather(
        torch.tensor(collectives.axis_index(mesh, "model")), mesh, "model"))
    return out


def fresh_state(X, C):
    """`init_state` of X with the centroids C."""
    st = tstate.init_state(X, C.shape[0])
    return dataclasses.replace(st, stats=dataclasses.replace(st.stats, C=C))


def _sharded(mesh, inp):
    """Two nested rounds, b_local = 300 then 600, on this rank's rows,
    the second capped at this rank's share of ``n_real``."""
    X = _rows(torch.from_numpy(inp["X"]), mesh, ("data",))
    st = fresh_state(X, torch.from_numpy(inp["C"]))
    out = {}
    for r, (b, n_real) in enumerate(((300, None), (600, int(inp["n_real"])))):
        step = distributed.make_sharded_round(
            mesh, ("data",), b_local=b, rho=math.inf, n_real=n_real)
        st, info = step(X, st)
        out[f"a_{r}"] = _np(st.points.a)
        out[f"C_{r}"] = _np(st.stats.C)
        for f in ("n_changed", "n_recomputed", "n_active", "grow",
                  "batch_mse"):
            out[f"{f}_{r}"] = _np(getattr(info, f))
    return out


# -- whole fits through the mesh engines --------------------------------------

#: the fit of the mesh cases (and of the JAX oracle): the blobs at b0=1000,
#: which tests/test_torch_fit.py holds to JAX on the local engine
FIT = dict(k=8, b0=1000, seed=0)
BOUNDS = ("hamerly2", "elkan")
#: the checkpointed fits save every SAVE_EVERY rounds and are killed by
#: their ``on_round`` at KILL_ROUND
SAVE_EVERY, KILL_ROUND = 4, 10
#: partial_fit: a fit of the first PARTIAL_FIT rows, then these batches
PARTIAL_FIT, PARTIAL_BATCHES = 2048, ((2048, 2548), (2548, 3048))


class Killed(Exception):
    pass


def kill_at(rec):
    if rec.round == KILL_ROUND:
        raise Killed


def schedule(km) -> np.ndarray:
    """(rounds, 4): b, n_recomputed, n_changed, grow of each round."""
    return np.array([(r.b, r.n_recomputed, r.n_changed, int(r.grow))
                     for r in km.telemetry_ if r.batch_mse is not None],
                    np.int64).reshape(-1, 4)


def record(km, tag: str) -> dict:
    """A fit's C, labels, schedule, final val MSE, telemetry but ``t``
    (as JSON, to compare bit for bit) and ``t`` (a resumed fit's early
    records are its checkpoint's)."""
    tel = []
    for r in km.telemetry_:
        r = r.to_dict()
        r.pop("t")
        tel.append(r)
    return {f"C_{tag}": km.cluster_centers_, f"labels_{tag}": km.labels_,
            f"sched_{tag}": schedule(km),
            f"val_{tag}": np.float64(km.final_mse_),
            f"tel_{tag}": np.array(json.dumps(tel)),
            f"t_{tag}": np.array([r.t for r in km.telemetry_])}


def _mesh(mesh, inp):
    """The parts of ``inp["parts"]``, each a fit through the estimator
    (or the in-place check) on this rank; ``inp["dir"]`` holds the chunk
    store (``store``) and the checkpoint directories."""
    from repro_torch.analysis import donation
    from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans
    from repro_torch.data.store import ChunkStore, store_permutation
    X, Xv = inp["X"], inp["Xv"]
    wd = Path(str(inp["dir"]))
    coordinator = dist.get_rank() == 0
    out = {}

    def fit(tag, data=X, device="cpu", **kw):
        cfg = FitConfig(backend="mesh", **dict(FIT, **kw))
        km = NestedKMeans(cfg, mesh=mesh, device=device)
        km.fit(data, X_val=Xv)
        out.update(record(km, tag))
        return km

    def copy_dir(src, dst):
        if coordinator:
            shutil.copytree(src, dst)
        dist.barrier()

    def resumed(tag, ck):
        cfg = FitConfig(backend="mesh", checkpoint=CheckpointConfig(
            checkpoint_dir=str(ck), save_every=SAVE_EVERY), **FIT)
        km = NestedKMeans(cfg, mesh=mesh, device="cpu")
        km.fit(X, X_val=Xv, resume=True)
        out.update(record(km, tag))

    for part in [str(p) for p in inp["parts"]]:
        if part == "fits":
            for bounds in BOUNDS:
                km = fit(bounds, bounds=bounds)
            run = km.engine.begin(X, km.config.resolve(len(X)),
                                  device="cpu")
            out["device"] = np.array(str(run.device))
            out["rows"] = np.int64(run._Xd.shape[0])
        elif part == "multihost":
            cfg = FitConfig(backend="multihost", **FIT)
            km = NestedKMeans(cfg, device="cpu").fit(X, X_val=Xv)
            out.update(record(km, "multihost"))
        elif part == "store":
            fit("store", data=str(wd / "store"))
            with ChunkStore(wd / "store") as st:
                perm = store_permutation(st.n, st.chunk_rows, FIT["seed"])
            fit("permuted", data=X[perm], shuffle=False)
        elif part == "resume":
            ck = wd / f"port_ck_live{dist.get_world_size()}"
            cfg = FitConfig(backend="mesh", checkpoint=CheckpointConfig(
                checkpoint_dir=str(ck), save_every=SAVE_EVERY), **FIT)
            try:
                NestedKMeans(cfg, mesh=mesh, device="cpu",
                             on_round=kill_at).fit(X, X_val=Xv)
                raise RuntimeError(f"the fit ended before {KILL_ROUND}")
            except Killed:
                pass
            copy_dir(ck, wd / "port_ck")
            resumed("resumed", ck)
        elif part == "resume_jax":
            copy_dir(wd / "jax_ck", wd / "jax_ck_port")
            resumed("resumed_jax", wd / "jax_ck_port")
        elif part == "partial":
            cfg = FitConfig(backend="mesh", **FIT)
            km = NestedKMeans(cfg, mesh=mesh, device="cpu")
            km.fit(X[:PARTIAL_FIT])
            for lo, hi in PARTIAL_BATCHES:
                km.partial_fit(X[lo:hi])
            out["partial_C"] = km.cluster_centers_
            out["partial_counts"] = km.counts_
            out["partial_b"] = np.int64(km.telemetry_[-1].b)
        elif part == "card":
            # every rank on the one card (gloo carries CUDA tensors)
            from repro_torch.kernels import ops
            ops.reset_launch_counts()
            km = fit("card", device="cuda")
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            out["launches"] = np.array(
                [counts[n] for n in ("assign_top2", "cluster_sum",
                                     "fused_nested_round")])
            out["card_device"] = np.array(str(km.stats_.C.device))
        elif part == "inplace":
            found = donation.check_inplace(
                wd / "store", FitConfig(backend="mesh", **FIT),
                device="cpu", mesh=mesh)
            out["inplace"] = np.array([str(v) for v in found], dtype=str)
        else:
            raise ValueError(f"unknown part {part!r}")
    return out


# -- the XL engine (tests/test_torch_xl.py; tests/jax_xl_oracle.py) ----------

#: the unit rounds: rows a data rank takes from the mid-fit states, and
#: (name, bounds, capacity) of each; "hamerly2_cap" is the compacted path
XL_B = 1500
XL_ROUNDS = (("none", "none", None), ("hamerly2", "hamerly2", None),
             ("hamerly2_cap", "hamerly2", 1024), ("elkan", "elkan", None),
             ("exponion", "exponion", None))
#: the mid-fit states' bound families (the capacity variant shares one)
XL_FAMILIES = ("none", "hamerly2", "elkan", "exponion")
#: the fits held to JAX's XL fits of FIT on a (2, 2) mesh
XL_BOUNDS = ("hamerly2", "elkan")
XL_AXES = ("data", "model")
STATE_LEAVES = ("C", "S", "v", "sse", "p", "a", "d", "lb", "l", "round")


def xl_int_inputs():
    """Integer-valued rows, centroids (duplicates across the k-slices of
    2 and 4 model ranks) and labels (-1: unseen): every product and sum
    of them is exact, so any summation order gives the same bits."""
    rng = np.random.default_rng(7)
    x = rng.integers(-6, 7, (64, 5)).astype(np.float32)
    C = rng.integers(-6, 7, (8, 5)).astype(np.float32)
    C[6] = C[1]
    a = rng.integers(-1, 8, 64).astype(np.int32)
    return x, C, a


def xl_tag(shape) -> str:
    return "x".join(map(str, shape))


def _state_of(inp, fam, device="cpu"):
    """The mid-fit state of family ``fam`` from ``inp`` (its numpy
    leaves under ``mid_<fam>_<leaf>``)."""
    from repro_torch.convert import state_from_numpy
    g = {f: inp.get(f"mid_{fam}_{f}") for f in STATE_LEAVES}
    return state_from_numpy(types.SimpleNamespace(
        stats=types.SimpleNamespace(C=g["C"], S=g["S"], v=g["v"],
                                    sse=g["sse"], p=g["p"]),
        points=types.SimpleNamespace(a=g["a"], d=g["d"], lb=g["lb"]),
        elkan=(None if g["l"] is None
               else types.SimpleNamespace(l=g["l"])),
        round=g["round"]), device=device)


def _whole_state(st, mesh):
    """A rank's XL state made whole: stats over the model dim, points over
    the data dim, the elkan bounds over both."""
    def whole_k(t, dim=0):
        return collectives.all_gather(t, mesh, "model").movedim(
            0, dim).flatten(dim, dim + 1)
    out = {f: _np(whole_k(getattr(st.stats, f)))
           for f in ("C", "S", "v", "sse", "p")}
    for f in ("a", "d", "lb"):
        out[f] = _np(collectives.gather_rows(getattr(st.points, f), mesh,
                                             ("data",)))
    if st.elkan is not None:
        out["l"] = _np(collectives.gather_rows(whole_k(st.elkan.l, 1), mesh,
                                               ("data",)))
    return out


def _xl_units(mesh, tag, inp, out):
    """The sharded helpers on integer inputs, one XL round of each of
    `XL_ROUNDS` from its family's mid-fit state, the S/v and sse deltas of
    that round, the row chunks, and a cross-shard exact tie."""
    from repro_torch.core import distributed_xl as dxl
    from repro_torch.core.state import ElkanBounds
    m = collectives.axis_size(mesh, "model")
    off_of = collectives.axis_index(mesh, "model")
    x, C, a = (torch.from_numpy(t) for t in xl_int_inputs())
    kl = C.shape[0] // m
    Cl = C[off_of * kl:(off_of + 1) * kl]

    def whole_k(t, dim=0):
        return _np(collectives.all_gather(t, mesh, "model").movedim(
            0, dim).flatten(dim, dim + 1))

    out[f"{tag}_dist"] = _np(dxl._dist_to_assigned_sharded(
        x, Cl, a, off_of * kl, mesh, "model"))
    out[f"{tag}_half"] = _np(dxl._half_intercentroid_sharded(Cl, mesh,
                                                             "model"))
    B, s = dxl._exponion_geom_xl(Cl, mesh, "model", off_of * kl)
    out[f"{tag}_B"], out[f"{tag}_s"] = whole_k(B, 1), _np(s)
    out[f"{tag}_chunk"] = _np(dxl._chunk_rows(
        [torch.arange(XL_B + 1)], mesh=mesh, model_axis="model")[0])

    X = torch.from_numpy(inp["Xmid"])
    Xl = _rows(X, mesh, ("data",))
    k = C.shape[0]
    for name, bounds, cap in XL_ROUNDS:
        full = _state_of(inp, bounds)
        st = dxl.shard_state_xl(full, mesh, ("data",), "model")
        if full.elkan is not None:
            rows = _rows(full.elkan.l, mesh, ("data",))
            st = dataclasses.replace(st, elkan=ElkanBounds(
                l=rows[:, off_of * kl:(off_of + 1) * kl].clone()))
        step = dxl.make_xl_nested_round(mesh, ("data",), b_local=XL_B,
                                        rho=math.inf, bounds=bounds,
                                        capacity=cap)
        new, info = step(Xl, st)
        for f, v in _whole_state(new, mesh).items():
            out[f"{tag}_{name}_{f}"] = v
        for f in ("batch_mse", "n_changed", "n_recomputed", "n_active",
                  "overflow", "grow", "r_median", "p_max"):
            out[f"{tag}_{name}_info_{f}"] = _np(getattr(info, f))
        a_prev, a_new = st.points.a[:XL_B], new.points.a[:XL_B]
        dS, dv = dxl._delta_sv_xl(Xl[:XL_B], a_prev, a_new, k, mesh=mesh,
                                  model_axis="model", plan=None)
        sse = dxl._refresh_sse_xl(new.points.d[:XL_B], a_new, k, mesh=mesh,
                                  model_axis="model", plan=None)
        dS, dv, sse = collectives.psum((dS, dv, sse), mesh, ("data",))
        out[f"{tag}_{name}_dS"] = whole_k(dS)
        out[f"{tag}_{name}_dv"] = whole_k(dv)
        out[f"{tag}_{name}_dsse"] = whole_k(sse)

    # the exact tie: rows on centroids 1 and 6 (copies of each other, in
    # different k-slices) and on centroid 2, from a fresh state
    Ct = torch.from_numpy(inp["Xmid"][:8].copy())
    Ct[6] = Ct[1]
    xt = Ct[[1, 6, 2, 0]].clone()
    for bounds in XL_FAMILIES:
        st = dxl.shard_state_xl(fresh_state(xt, Ct), mesh, (), "model")
        if bounds == "elkan":
            st = dataclasses.replace(st, elkan=ElkanBounds(
                l=torch.zeros((4, kl))))
        new, _ = dxl.xl_nested_round(xt, st, b=4, rho=math.inf,
                                     bounds=bounds, mesh=mesh,
                                     data_axes=("data",), model_axis="model")
        out[f"{tag}_tie_{bounds}"] = _np(new.points.a)


def _xl_engine(mesh, inp):
    """The parts of ``inp["parts"]``, each ``<what>:<mesh shape>`` (e.g.
    ``fits:2x2``) on a ``(data, model)`` mesh of that shape over every
    rank; ``inp["dir"]`` holds the chunk store (``store``), the
    checkpoints and the JAX package's killed XL checkpoint
    (``jax_xl_ck``)."""
    from repro_torch.analysis import donation
    from repro_torch.api import CheckpointConfig, FitConfig, NestedKMeans
    X, Xv = inp["X"], inp["Xv"]
    wd = Path(str(inp["dir"]))
    coordinator = dist.get_rank() == 0
    meshes = {xl_tag(mesh.shape): mesh}
    out = {}

    def fit(tag, mesh, data=X, on_round=None, resume=False, ck=None,
            **kw):
        cfg = FitConfig(**dict(dict(FIT, backend="xl"), checkpoint=(
            None if ck is None else CheckpointConfig(
                checkpoint_dir=str(ck), save_every=SAVE_EVERY)), **kw))
        km = NestedKMeans(cfg, mesh=mesh, device="cpu", on_round=on_round)
        km.fit(data, X_val=Xv, resume=resume)
        out.update(record(km, tag))
        return km

    def copy_dir(src, dst):
        if coordinator:
            shutil.copytree(src, dst)
        dist.barrier()

    for part in [str(p) for p in inp["parts"]]:
        what, tag = part.split(":")
        shape = tuple(int(n) for n in tag.split("x"))
        if tag not in meshes:
            meshes[tag] = make_host_mesh(shape, XL_AXES)
        mesh = meshes[tag]
        if what == "units":
            _xl_units(mesh, tag, inp, out)
        elif what == "fits":
            for bounds in XL_BOUNDS:
                fit(f"{tag}_{bounds}", mesh, bounds=bounds)
            run = NestedKMeans(FitConfig(**dict(FIT, backend="xl")),
                               mesh=mesh, device="cpu").engine.begin(
                X, FitConfig(**dict(FIT, backend="xl")).resolve(len(X)),
                device="cpu")
            out[f"{tag}_rows"] = np.int64(run._Xd.shape[0])
        elif what == "mesh_equal":
            fit(f"{tag}_xl", mesh)
            km = NestedKMeans(FitConfig(backend="mesh", **FIT), mesh=mesh,
                              device="cpu").fit(X, X_val=Xv)
            out.update(record(km, f"{tag}_mesh"))
        elif what == "families":
            for bounds in ("none", "exponion"):
                fit(f"{tag}_{bounds}", mesh, bounds=bounds)
        elif what == "families":
            for bounds in ("none", "exponion"):
                fit(f"{tag}_{bounds}", mesh, bounds=bounds)
        elif what == "growth":
            fit(f"{tag}_rho", mesh, rho=0.5, max_rounds=12)
        elif what == "resume":
            ck = wd / f"port_xl_ck_live{tag}"
            try:
                fit(f"{tag}_killed", mesh, on_round=kill_at, ck=ck)
                raise RuntimeError(f"the fit ended before {KILL_ROUND}")
            except Killed:
                pass
            copy_dir(ck, wd / f"port_xl_ck{tag}")
            fit(f"{tag}_resumed", mesh, resume=True, ck=ck)
        elif what == "resume_jax":
            copy_dir(wd / "jax_xl_ck", wd / f"jax_xl_ck_port{tag}")
            fit(f"{tag}_resumed_jax", mesh, resume=True,
                ck=wd / f"jax_xl_ck_port{tag}")
        elif what == "resume_local":
            copy_dir(wd / "local_ck", wd / f"local_ck_xl{tag}")
            fit(f"{tag}_resumed_local", mesh, resume=True,
                ck=wd / f"local_ck_xl{tag}")
        elif what == "partial":
            cfg = FitConfig(**dict(FIT, backend="xl"))
            km = NestedKMeans(cfg, mesh=mesh, device="cpu")
            km.fit(X[:PARTIAL_FIT])
            for lo, hi in PARTIAL_BATCHES:
                km.partial_fit(X[lo:hi])
            out[f"{tag}_partial_C"] = km.cluster_centers_
            out[f"{tag}_partial_counts"] = km.counts_
            out[f"{tag}_partial_b"] = np.int64(km.telemetry_[-1].b)
        elif what == "card":
            # every rank on the one card: gloo carries the CUDA tensors
            from repro_torch.kernels import ops
            m, i = 2, collectives.axis_index(mesh, "model")
            t = torch.arange(8.0, device="cuda") + 10 * i
            other = torch.arange(8.0, device="cuda") + 10 * (1 - i)
            out[f"{tag}_card_ok"] = np.array([
                torch.equal(collectives.psum_scatter(t, mesh, "model"),
                            (t + other)[4 * i:4 * i + 4]),
                torch.equal(collectives.pmax(t, mesh, "model"),
                            torch.maximum(t, other)),
                torch.equal(collectives.pmin(t, mesh, "model"),
                            torch.minimum(t, other)),
                torch.equal(collectives.ppermute_ring(t, mesh, "model"),
                            other),
                collectives.ppermute_ring(t, mesh, "model").is_cuda])
            assert collectives.axis_size(mesh, "model") == m
            ops.reset_launch_counts()
            km = NestedKMeans(FitConfig(**dict(FIT, backend="xl")),
                              mesh=mesh, device="cuda").fit(X, X_val=Xv)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            out.update(record(km, f"{tag}_card"))
            out[f"{tag}_card_launches"] = np.array(
                [counts[n] for n in ("assign_top2", "cluster_sum")])
            out[f"{tag}_card_device"] = np.array(str(km.stats_.C.device))
        elif what == "inplace":
            found = donation.check_inplace(
                wd / "store", FitConfig(**dict(FIT, backend="xl")),
                device="cpu", mesh=mesh)
            out[f"{tag}_inplace"] = np.array([str(v) for v in found],
                                             dtype=str)
        else:
            raise ValueError(f"unknown part {part!r}")
    return out


#: the codebook case: each backend's build_codebook, then its service
CODEBOOK_BACKENDS = ("mesh", "xl")
CODEBOOK_SERVED = 96


def _codebook(mesh, inp):
    """`build_codebook` of ``inp["E"]`` at ``k`` on each backend of
    `CODEBOOK_BACKENDS` over the whole group (its own (data, model)
    mesh), the adopted local codebook's service folding in the first
    `CODEBOOK_SERVED` rows, and a `ClusterService` over a sharded
    estimator of the group, which must be refused."""
    import time

    from repro_torch.api import FitConfig, NestedKMeans
    from repro_torch.launch.serve import build_codebook
    from repro_torch.serve import ClusterService, IngestQueue
    E, k = inp["E"], int(inp["k"])
    out = {}
    for backend in CODEBOOK_BACKENDS:
        km = build_codebook(E, k, 0, backend=backend, device="cpu")
        out[f"C_{backend}"] = km.cluster_centers_
        out[f"engine_{backend}"] = np.array(km.config.backend)
        n0 = float(np.sum(km.counts_))
        svc = ClusterService(km, micro_batch=32, flush_after_s=0.01,
                             queue=IngestQueue(max_rows=1024, dedup=True))
        svc.start()
        ids = np.arange(CODEBOOK_SERVED)
        # every row twice: dedup by id keeps one of each
        svc.ingest(E[ids], ids=ids.tolist())
        svc.ingest(E[ids], ids=ids.tolist())
        deadline = time.monotonic() + 30.0
        while svc.queue.depth and time.monotonic() < deadline:
            time.sleep(0.005)
        svc.stop()
        out[f"folded_{backend}"] = np.float64(np.sum(km.counts_) - n0)
        out[f"rows_{backend}"] = np.int64(
            svc.export_metrics()["refresh"]["rows"])
        out[f"labels_{backend}"] = svc.predict(E)
        out[f"verified_{backend}"] = np.bool_(svc.snapshot.verify())
        sharded = NestedKMeans(FitConfig(k=k, backend=backend),
                               mesh=mesh, device="cpu")
        try:
            ClusterService(sharded)
            out[f"refused_{backend}"] = np.array("")
        except ValueError as e:
            out[f"refused_{backend}"] = np.array(str(e))
    return out


def _compress(mesh, inp):
    """`optim.compression.compressed_psum` of this rank's ``g[rank]`` and
    ``e[rank]`` over the whole group."""
    from repro_torch.optim import compression
    r = dist.get_rank()
    s, err = compression.compressed_psum(
        {"g": torch.from_numpy(inp["g"][r])},
        {"g": torch.from_numpy(inp["e"][r])})
    return {"s": _np(s["g"]), "err": _np(err["g"])}


# -- the sharded LM train step -------------------------------------------------

#: cells of the sharded train step held against JAX's sharded step
#: (tests/jax_sharding_oracle.py): name -> (arch, ("data", "model") mesh
#: shape, arm, reduced-config overrides). The seqpar cell's 6 heads do
#: not divide its 4-wide model dim, so its attention is context-parallel.
SHARDED_CELLS = {
    **{f"{fam}-{arm}": (arch, (2, 2), arm, {})
       for fam, arch in (("dense", "tinyllama-1.1b"),
                         ("moe", "granite-moe-1b-a400m"),
                         ("ssm", "mamba2-2.7b"),
                         ("hybrid", "jamba-v0.1-52b"),
                         ("encdec", "whisper-tiny"),
                         ("vlm", "internvl2-76b"))
       for arm in ("f32", "bf16")},
    "seqpar-f32": ("tinyllama-1.1b", (1, 4), "f32",
                   {"n_heads": 6, "n_kv_heads": 2}),
}
SH_BATCH, SH_SEQ, SH_MICRO = 8, 16, 2
#: AdamW's first step maps a gradient g to lr * g / (|g| + eps), whose
#: slope at g = 0 is lr / eps: at the default eps 1e-8 an element whose
#: gradient is ~1e-9 in both packages (their f32 sums agree to ~2e-6 of
#: the leaf) lands up to ~1e-4 apart, which puts a param leaf past 1e-5
#: relative (the reduced jamba's w_gate 1.005e-5, conv_bc 2.07e-5).
#: eps 1e-6 keeps the update's slope within 1e6 and the comparison a
#: test of the update.
SH_OPT = dict(lr=3e-3, warmup_steps=2, decay_steps=20, eps=1e-6)
SH_REMAT = False
SH_AXES = ("data", "model")
#: the EP layer cells: granite's first MoE layer on (2, 2) (the kept
#: masks, against JAX's) and, at a capacity factor that drops nothing,
#: on (1, 4) (against the dense dispatch)
EP_ROWS, EP_NODROP_CF = 4, 100.0


def sharded_config(arch: str, overrides: dict, cf=None):
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_reduced(arch), **overrides)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _sh_params(inp, cell, arm):
    """The cell's JAX weights (every leaf f32 in ``inputs.npz``, bf16
    ones exact) in the port's dtypes, or f32 in the f32 arm."""
    return _sh_params_of(inp, cell, arm, SHARDED_CELLS)


def _sh_params_of(inp, cell, arm, cells):
    from repro_torch.launch.input_specs import abstract_params
    from repro_torch.models.sharding import _path_str, tree_map_with_path
    arch, _, _, over = cells[cell]
    cfg = sharded_config(arch, over)
    return cfg, tree_map_with_path(
        lambda path, t: torch.from_numpy(
            inp[f"w:{cell}:{_path_str(path)}"]).to(
                torch.float32 if arm == "f32" else t.dtype),
        abstract_params(cfg))


def _sharded_train(_mesh, inp):
    """One step of each cell named in ``inp["cells"]`` (n_micro
    `SH_MICRO`, `SH_OPT`, zero moments) on its own mesh of this group:
    the loss, the grad norm and the whole params and moments after it;
    then the EP layer cells."""
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as S
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.util.tree import tree_leaves
    out = {}
    meshes = {}
    for cell in json.loads(str(inp["cells"])):
        arch, shape, arm, _ = SHARDED_CELLS[cell]
        mesh = meshes.setdefault(shape, make_host_mesh(shape, SH_AXES))
        cfg, params = _sh_params(inp, cell, arm)
        batch = {k: torch.from_numpy(inp[f"b:{cell}:{k}"])
                 for k in ("tokens", "labels", "frames", "patches")
                 if f"b:{cell}:{k}" in inp}
        for k in ("frames", "patches"):
            if k in batch:
                batch[k] = batch[k].to(params["embed"].dtype)
        specs = S.param_specs(cfg, mesh, params)
        local = S.shard_tree(params, specs, mesh)
        rows = S.shard_tree(batch, S.batch_specs(cfg, mesh, batch), mesh)
        step = tstep.make_train_step(cfg, n_micro=SH_MICRO, mesh=mesh,
                                     opt_cfg=adamw.AdamWConfig(**SH_OPT),
                                     remat=SH_REMAT, device="cpu")
        local, opt, m = step(local, adamw.init(local), rows)
        out[f"{cell}:loss"] = _np(m["loss"])
        out[f"{cell}:grad_norm"] = _np(m["grad_norm"])
        for what, tree in (("params", local), ("mu", opt.mu),
                           ("nu", opt.nu)):
            for i, t in enumerate(tree_leaves(S.gather_tree(tree, specs,
                                                            mesh))):
                out[f"{cell}:{what}:{i}"] = _np(t.float())
    if "ep_x" in inp:
        _ep_layers(inp, out, meshes, L, S)
    if "placements" in inp:
        _placements(out, S)
    return out


#: (mesh shape, axes, spec) cases of `sharding.placements`, each held
#: against DTensor's own layout of the same placements
PLACEMENT_CASES = (
    ((2, 2, 1), ("pod", "data", "model"), (("pod", "data"), None)),
    ((2, 2, 1), ("pod", "data", "model"), (None, ("data", "model"))),
    ((2, 2), SH_AXES, ("model", "data")),
    ((2, 2), SH_AXES, (("data", "model"), None)),
    ((2, 2), SH_AXES, (None, "model")),
)


def _placements(out, S):
    """For each `PLACEMENT_CASES` spec, whether DTensor lays an (8, 12)
    tensor out over `sharding.placements` as `sharding.shard_tree` cuts
    it, and puts the blocks back as `sharding.gather_tree` does."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    full = torch.arange(96, dtype=torch.float32).reshape(8, 12)
    for i, (shape, axes, spec) in enumerate(PLACEMENT_CASES):
        mesh = make_host_mesh(shape, axes)
        pl = S.placements(spec, mesh)
        mine = S.shard_tree({"t": full}, {"t": spec}, mesh)["t"]
        theirs = distribute_tensor(full, mesh, pl, src_data_rank=None)
        back = S.gather_tree({"t": mine}, {"t": spec}, mesh)["t"]
        whole = DTensor.from_local(mine, mesh, pl).full_tensor()
        out[f"placements:{i}"] = np.array(
            [torch.equal(theirs.to_local(), mine), torch.equal(back, full),
             torch.equal(whole, full)])


def _ep_layers(inp, out, meshes, L, S):
    """granite's first MoE layer (the weights of the ``moe-f32`` cell) on
    ``ep_x``: on (2, 2) at the config's capacity factor, each rank's kept
    mask (`layers._slots`' ``valid``) and the whole output; on (1, 4) at
    `EP_NODROP_CF`, the EP output and aux."""
    _, params = _sh_params(inp, "moe-f32", "f32")
    x = torch.from_numpy(inp["ep_x"])
    seen = []
    orig = L._slots

    def spy(*a):
        valid, slot = orig(*a)
        seen.append(valid)
        return valid, slot

    for shape, cf, tag in (((2, 2), None, "ep"),
                           ((1, 4), EP_NODROP_CF, "ep_nodrop")):
        mesh = meshes.setdefault(shape, make_host_mesh(shape, SH_AXES))
        cfg = sharded_config("granite-moe-1b-a400m", {}, cf)
        specs = S.param_specs(cfg, mesh, params)
        local = S.shard_tree(params, specs, mesh)
        xs = S.shard_tree({"x": x}, {"x": (S.data_axes(mesh), None, None)},
                          mesh)["x"]
        seen.clear()
        L._slots = spy
        try:
            with L.use_mesh(mesh, specs):
                p = L.gathered({"moe": {k: v[0] for k, v in
                                        local["blocks"]["0"]["moe"].items()}},
                               "blocks.0", stacked=True)["moe"]
                y, aux = L.moe_fwd(p, xs, cfg.moe)
        finally:
            L._slots = orig
        out[f"{tag}:valid"] = _np(seen[0])
        out[f"{tag}:out"] = _np(collectives.gather_rows(
            y, mesh, S.data_axes(mesh)))
        out[f"{tag}:aux"] = _np(aux)


#: the sharded serving cells: (arch, mesh shape, arm, config overrides):
#: the six families on (2, 2) in f32, the hybrid one in bf16 too (it
#: runs attention, the SSD and the MoE); on (1, 4), 8
#: heads over 2 K/V heads keep the query heads sharded and split the cache
#: over positions (dense, and MoE), 6 over 2 keep every head whole
#: (context-parallel prefill) and split the cache over positions too
SERVE_CELLS = {
    **{f"{fam}-f32": (arch, (2, 2), "f32", {})
       for fam, arch in (("dense", "tinyllama-1.1b"),
                         ("moe", "granite-moe-1b-a400m"),
                         ("ssm", "mamba2-2.7b"),
                         ("hybrid", "jamba-v0.1-52b"),
                         ("encdec", "whisper-tiny"),
                         ("vlm", "internvl2-76b"))},
    "hybrid-bf16": ("jamba-v0.1-52b", (2, 2), "bf16", {}),
    "seqkv-f32": ("tinyllama-1.1b", (1, 4), "f32",
                  {"n_heads": 8, "n_kv_heads": 2}),
    "seqkv-moe-f32": ("granite-moe-1b-a400m", (1, 4), "f32",
                      {"n_heads": 8, "n_kv_heads": 2}),
    "seqall-f32": ("tinyllama-1.1b", (1, 4), "f32",
                   {"n_heads": 6, "n_kv_heads": 2}),
}
#: prompt rows and length, decode steps
SV_BATCH, SV_PROMPT, SV_GEN = 4, 16, 3


def serve_cache_len(cfg) -> int:
    """The cell's cache length: the prompt (the vlm's patches too) and
    the decode steps, rounded up to split over 4 positions' ranks."""
    n = SV_PROMPT + SV_GEN + (cfg.encoder.n_ctx if cfg.family == "vlm"
                              else 0)
    return n + -n % 4


def _sharded_serve(_mesh, inp):
    """Each cell of ``inp["cells"]`` on its own mesh: the sharded prefill
    of the cell's prompt, then `SV_GEN` decode steps of the tokens
    ``d:<cell>`` (column i at step i); the whole last-position logits of
    each step and the whole cache after the prefill and at the end."""
    from repro_torch.models import model as M
    from repro_torch.models import sharding as S
    from repro_torch.train import step as tstep
    from repro_torch.util.tree import tree_leaves
    out, meshes = {}, {}
    for cell in json.loads(str(inp["cells"])):
        arch, shape, arm, over = SERVE_CELLS[cell]
        mesh = meshes.setdefault(shape, make_host_mesh(shape, SH_AXES))
        cfg = sharded_config(arch, over)
        _, params = _sh_params_of(inp, cell, arm, SERVE_CELLS)
        batch = {k: torch.from_numpy(inp[f"b:{cell}:{k}"])
                 for k in ("tokens", "frames", "patches")
                 if f"b:{cell}:{k}" in inp}
        for k in ("frames", "patches"):
            if k in batch:
                batch[k] = batch[k].to(params["embed"].dtype)
        specs = S.param_specs(cfg, mesh, params)
        local = S.shard_tree(params, specs, mesh)
        rows = S.shard_tree(batch, S.batch_specs(cfg, mesh, batch), mesh)
        cache_len = serve_cache_len(cfg)
        pre = tstep.make_prefill_step(cfg, cache_len=cache_len, mesh=mesh,
                                      device="cpu")
        dec = tstep.make_decode_step(cfg, mesh=mesh, device="cpu")
        logits, cache = pre(local, rows)
        meta = M.make_decode_cache(cfg, batch=SV_BATCH, cache_len=cache_len,
                                   dtype=params["embed"].dtype, device="meta")
        cspecs = S.cache_specs(cfg, mesh, meta)

        def whole_cache(c):
            return [_np(t.float()) for t in tree_leaves(
                S.gather_tree(c, cspecs, mesh))]

        for i, t in enumerate(whole_cache(cache)):
            out[f"{cell}:cache0:{i}"] = t
        steps = [tstep.whole_logits(logits, cfg, mesh)[:, -1]]
        toks = torch.from_numpy(inp[f"d:{cell}"])
        for j in range(SV_GEN):
            tok = S.shard_tree({"t": toks[:, j:j + 1]},
                               {"t": (S.data_axes(mesh), None)}, mesh)["t"]
            logits, cache = dec(local, tok, cache)
            steps.append(tstep.whole_logits(logits, cfg, mesh)[:, -1])
        out[f"{cell}:logits"] = _np(torch.stack(steps).float())
        for i, t in enumerate(whole_cache(cache)):
            out[f"{cell}:cache:{i}"] = t
    return out


CASES = {"dp": _dp, "xl": _xl, "sharded": _sharded, "mesh": _mesh,
         "xl_engine": _xl_engine, "codebook": _codebook,
         "compress": _compress, "sharded_train": _sharded_train,
         "sharded_serve": _sharded_serve}


def spawn(out_dir, case: str, shape, axes, *, timeout_s: float = 120.0,
          **inputs):
    """Run ``case`` on prod(shape) spawned ranks with ``inputs``; their
    outputs by rank. Raises `TimeoutError` when the ranks are not done
    in ``timeout_s`` (a stuck rank is killed, not waited for)."""
    out_dir = Path(out_dir)
    np.savez(out_dir / "inputs.npz", **inputs)
    world = math.prod(shape)
    spawn_and_join(run, (world, str(out_dir), case, shape, axes), world,
                   timeout_s, case)
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(world)]


def run(rank: int, world: int, out_dir: str, case: str, shape, axes):
    torch.set_num_threads(1)
    out = Path(out_dir)
    dist.init_process_group(
        "gloo", init_method=f"file://{out / 'store'}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_host_mesh(shape, axes)
        inp = dict(np.load(out / "inputs.npz"))
        np.savez(out / f"rank{rank}.npz", **CASES[case](mesh, inp))
    finally:
        dist.destroy_process_group()

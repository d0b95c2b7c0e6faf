"""One rank of a gloo process group on the CPU, for
tests/test_torch_distributed.py and tests/test_torch_mesh.py.

The test spawns ``world`` ranks of `run` with
``torch.multiprocessing.start_processes(..., start_method="spawn")``. Each
rank joins the group through a `FileStore` file, builds the mesh, runs one
case on its shard of the inputs the test wrote to ``inputs.npz`` (the
round cases), or fits the whole of them through the mesh engines (the
``mesh`` case, whose parts the test names in ``inputs.npz``), and writes
its outputs to ``rank<r>.npz`` beside it. This module imports no JAX:
only torch, numpy and the port. tests/jax_mesh_oracle.py reads the fit's
config and the kill schedule from here.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import math
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

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


CASES = {"dp": _dp, "xl": _xl, "sharded": _sharded, "mesh": _mesh}


def spawn(out_dir, case: str, shape, axes, *, timeout_s: float = 120.0,
          **inputs):
    """Run ``case`` on prod(shape) spawned ranks with ``inputs``; their
    outputs by rank. Raises `TimeoutError` when the ranks are not done
    in ``timeout_s`` (a stuck rank is killed, not waited for)."""
    import time

    import torch.multiprocessing as tmp
    out_dir = Path(out_dir)
    np.savez(out_dir / "inputs.npz", **inputs)
    world = math.prod(shape)
    ctx = tmp.start_processes(
        run, args=(world, str(out_dir), case, shape, axes), nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{case}: ranks did not finish in "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
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

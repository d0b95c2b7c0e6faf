"""One rank of a gloo process group on the CPU, for
tests/test_torch_distributed.py.

The test spawns ``world`` ranks of `run` with
``torch.multiprocessing.start_processes(..., start_method="spawn")``. Each
rank joins the group through a `FileStore` file, builds the mesh, runs one
case on its shard of the inputs the test wrote to ``inputs.npz``, and
writes its outputs to ``rank<r>.npz`` beside it. This module imports no
JAX: only torch, numpy and the port.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
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


CASES = {"dp": _dp, "xl": _xl, "sharded": _sharded}


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

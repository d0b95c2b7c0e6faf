"""The JAX package's XL engine on forced host devices: the oracle of
tests/test_torch_xl.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_xl_oracle.py WORKDIR

It runs in a process of its own, because the test process must see the
one real CPU device (tests/conftest.py). It reads ``WORKDIR/inputs.npz``
(``X``, ``Xv``, ``Xmid`` and the mid-fit states ``mid_<family>_<leaf>``)
and writes ``WORKDIR/jax_xl.npz``:

* on (1, 2), (2, 2) and (1, 4) ("data", "model") meshes: the sharded
  helpers on the integer inputs of `xl_int_inputs`, the row chunks, and
  one `xl_nested_round` of each of `XL_ROUNDS` from its family's mid-fit
  state with the S/v and sse deltas of that round, under the keys the
  gloo ranks write (tests/torch_dist_worker.py);
* on the (2, 2) mesh, the XL fit of ``FIT`` for each of `XL_BOUNDS`: the
  centroids, labels, final validation MSE and per-round schedule;
* ``WORKDIR/jax_xl_ck``: the (2, 2) hamerly2 fit with a checkpoint every
  ``SAVE_EVERY`` rounds, killed at round ``KILL_ROUND``.
"""
from __future__ import annotations

import math
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.api import CheckpointConfig, FitConfig, NestedKMeans
from repro.core import distributed_xl as dxl
from repro.core.distributed import shard_map_compat
from repro.core.state import (ClusterStats, ElkanBounds, KMeansState,
                              PointState)
from repro.kernels.plan import resolve_plan
from torch_dist_worker import (FIT, KILL_ROUND, SAVE_EVERY, XL_AXES, XL_B,
                               XL_BOUNDS, XL_ROUNDS, Killed, kill_at,
                               schedule, xl_int_inputs, xl_tag)

SHAPES = ((1, 2), (2, 2), (1, 4))


def _sm(fn, mesh, in_specs, out_specs):
    return jax.jit(shard_map_compat(fn, mesh=mesh, in_specs=in_specs,
                                    out_specs=out_specs))


def _mid_state(inp, fam) -> KMeansState:
    g = {f: inp[f"mid_{fam}_{f}"] for f in
         ("C", "S", "v", "sse", "p", "a", "d", "lb", "round")}
    el = inp.get(f"mid_{fam}_l")
    return KMeansState(
        stats=ClusterStats(*(jnp.asarray(g[f]) for f in
                             ("C", "S", "v", "sse", "p"))),
        points=PointState(*(jnp.asarray(g[f]) for f in ("a", "d", "lb"))),
        elkan=None if el is None else ElkanBounds(l=jnp.asarray(el)),
        round=jnp.asarray(g["round"]))


def units(mesh, inp, out) -> None:
    tag = xl_tag(tuple(mesh.devices.shape))
    m = mesh.shape["model"]
    x, C, a = (jnp.asarray(t) for t in xl_int_inputs())
    k = C.shape[0]
    kl = k // m

    def offset():
        return jax.lax.axis_index("model") * kl

    out[f"{tag}_dist"] = _sm(
        lambda xs, Cl, av: dxl._dist_to_assigned_sharded(
            xs, Cl, av, offset(), "model"),
        mesh, (P(), P("model", None), P()), P())(x, C, a)
    out[f"{tag}_half"] = _sm(
        lambda Cl: dxl._half_intercentroid_sharded(Cl, "model", m),
        mesh, (P("model", None),), P())(C)
    out[f"{tag}_B"], out[f"{tag}_s"] = _sm(
        lambda Cl: dxl._exponion_geom_xl(Cl, "model", m, offset()),
        mesh, (P("model", None),), (P(None, "model"), P()))(C)
    out[f"{tag}_chunk"] = _sm(
        lambda v: dxl._chunk_rows([v], m=m, model_axis="model")[0],
        mesh, (P(),), P(XL_AXES))(jnp.arange(XL_B + 1))

    plan = resolve_plan("ref", b=XL_B, k=k, d=inp["Xmid"].shape[1])
    Xd = jax.device_put(jnp.asarray(inp["Xmid"]),
                        NamedSharding(mesh, P(("data",), None)))
    for name, bounds, cap in XL_ROUNDS:
        st = _mid_state(inp, bounds)
        specs = dxl.xl_state_specs(("data",), "model",
                                   elkan=st.elkan is not None)
        st = jax.tree.map(
            lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), st,
            specs)
        step = dxl.make_xl_nested_round(mesh, ("data",), model_axis="model",
                                        b_local=XL_B, rho=math.inf,
                                        bounds=bounds, capacity=cap,
                                        plan=plan)
        new, info = step(Xd, st)
        for f in ("C", "S", "v", "sse", "p"):
            out[f"{tag}_{name}_{f}"] = getattr(new.stats, f)
        for f in ("a", "d", "lb"):
            out[f"{tag}_{name}_{f}"] = getattr(new.points, f)
        if new.elkan is not None:
            out[f"{tag}_{name}_l"] = new.elkan.l
        for f in ("batch_mse", "n_changed", "n_recomputed", "n_active",
                  "overflow", "grow", "r_median", "p_max"):
            out[f"{tag}_{name}_info_{f}"] = getattr(info, f)

        def deltas(Xs, ap, an, dn):
            ap, an = ap[:XL_B], an[:XL_B]
            dS, dv = dxl._delta_sv_xl(Xs[:XL_B], ap, an, k, m=m,
                                      model_axis="model",
                                      data_axes=("data",), plan=plan)
            sse = dxl._refresh_sse_xl(dn[:XL_B], an, k, m=m,
                                      model_axis="model",
                                      data_axes=("data",))
            return dS, dv, sse

        row = P("data")
        (out[f"{tag}_{name}_dS"], out[f"{tag}_{name}_dv"],
         out[f"{tag}_{name}_dsse"]) = _sm(
            deltas, mesh, (P("data", None), row, row, row),
            (P("model", None), P("model"), P("model")))(
            Xd, st.points.a, new.points.a, new.points.d)


def main(workdir: str) -> None:
    wd = Path(workdir)
    inp = dict(np.load(wd / "inputs.npz"))
    X, Xv = inp["X"], inp["Xv"]
    out = {}
    devs = np.array(jax.devices()[:4])
    meshes = {s: Mesh(devs[:s[0] * s[1]].reshape(s), XL_AXES)
              for s in SHAPES}
    for mesh in meshes.values():
        units(mesh, inp, out)
    mesh = meshes[(2, 2)]
    for bounds in XL_BOUNDS:
        cfg = FitConfig(backend="xl", kernel_backend="ref",
                        **dict(FIT, bounds=bounds))
        km = NestedKMeans(cfg, mesh=mesh).fit(X, X_val=Xv)
        tag = f"2x2_{bounds}"
        out[f"C_{tag}"] = km.cluster_centers_
        out[f"labels_{tag}"] = km.labels_
        out[f"sched_{tag}"] = schedule(km)
        out[f"val_{tag}"] = np.float64(km.final_mse_)
    ck = CheckpointConfig(checkpoint_dir=str(wd / "jax_xl_ck_live"),
                          save_every=SAVE_EVERY)
    cfg = FitConfig(backend="xl", kernel_backend="ref", checkpoint=ck,
                    **FIT)
    try:
        NestedKMeans(cfg, mesh=mesh, on_round=kill_at).fit(X, X_val=Xv)
        raise SystemExit(f"the fit ended before round {KILL_ROUND}")
    except Killed:
        pass
    shutil.copytree(wd / "jax_xl_ck_live", wd / "jax_xl_ck")
    np.savez(wd / "jax_xl.npz",
             **{key: np.asarray(v) for key, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1])

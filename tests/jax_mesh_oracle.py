"""The JAX package's mesh engine on forced host devices: the oracle of
tests/test_torch_mesh.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_mesh_oracle.py WORKDIR

It runs in a process of its own, because the test process must see the
one real CPU device (tests/conftest.py). It reads ``WORKDIR/inputs.npz``
(``X``, ``Xv``) and writes ``WORKDIR/jax.npz``:

* for 2 and 4 devices on a flat ("data",) mesh and for each bound family
  of `BOUNDS`: the centroids, labels, final validation MSE and per-round
  schedule (b, n_recomputed, n_changed, grow) of the fit of ``FIT``;
* ``WORKDIR/jax_ck``: the 4-device hamerly2 fit with a checkpoint every
  ``SAVE_EVERY`` rounds, killed at round ``KILL_ROUND``;
* where ``WORKDIR/port_ck`` holds a checkpoint (the port's 2-rank fit,
  killed the same way), that fit resumed on 4 devices: its schedule,
  centroids and labels.

The fit, its bound families and the kill schedule are the gloo ranks'
own (tests/torch_dist_worker.py), so both packages run the same fits.
"""
from __future__ import annotations

import shutil
import sys
from pathlib import Path

import jax
import numpy as np
from jax.sharding import Mesh

from repro.api import CheckpointConfig, FitConfig, NestedKMeans
from torch_dist_worker import (BOUNDS, FIT, KILL_ROUND, SAVE_EVERY, Killed,
                               kill_at, schedule)


def main(workdir: str) -> None:
    wd = Path(workdir)
    inp = np.load(wd / "inputs.npz")
    X, Xv = inp["X"], inp["Xv"]
    out = {}
    meshes = {n: Mesh(np.array(jax.devices()[:n]), ("data",))
              for n in (2, 4)}
    for n, mesh in meshes.items():
        for bounds in BOUNDS:
            cfg = FitConfig(backend="mesh", kernel_backend="ref",
                            **dict(FIT, bounds=bounds))
            km = NestedKMeans(cfg, mesh=mesh).fit(X, X_val=Xv)
            tag = f"{bounds}_{n}"
            out[f"C_{tag}"] = km.cluster_centers_
            out[f"labels_{tag}"] = km.labels_
            out[f"sched_{tag}"] = schedule(km)
            out[f"val_{tag}"] = np.float64(km.final_mse_)
    ck = CheckpointConfig(checkpoint_dir=str(wd / "jax_ck_live"),
                          save_every=SAVE_EVERY)
    cfg = FitConfig(backend="mesh", kernel_backend="ref", checkpoint=ck,
                    **FIT)
    try:
        NestedKMeans(cfg, mesh=meshes[4], on_round=kill_at).fit(
            X, X_val=Xv)
        raise SystemExit(f"the fit ended before round {KILL_ROUND}")
    except Killed:
        pass
    shutil.copytree(wd / "jax_ck_live", wd / "jax_ck")
    if (wd / "port_ck").is_dir():
        # the resumed fit goes on saving: into a copy
        shutil.copytree(wd / "port_ck", wd / "port_ck_jax")
        ck = CheckpointConfig(checkpoint_dir=str(wd / "port_ck_jax"),
                              save_every=SAVE_EVERY)
        cfg = FitConfig(backend="mesh", kernel_backend="ref",
                        checkpoint=ck, **FIT)
        km = NestedKMeans(cfg, mesh=meshes[4]).fit(X, X_val=Xv,
                                                    resume=True)
        out["resumed_sched"] = schedule(km)
        out["resumed_C"] = km.cluster_centers_
        out["resumed_labels"] = km.labels_
        out["resumed_t"] = np.array([r.t for r in km.telemetry_])
    np.savez(wd / "jax.npz", **out)


if __name__ == "__main__":
    main(sys.argv[1])

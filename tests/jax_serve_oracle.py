"""The JAX package's sharded prefill and decode steps on forced host
devices: the oracle of tests/test_torch_sharded_serve.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_serve_oracle.py WORKDIR

It reads ``WORKDIR/inputs.npz`` (``cells``, a JSON list of
`SERVE_CELLS` names, each cell's weights ``w:<cell>:<path>``, its prompt
``b:<cell>:<name>`` and its decode tokens ``d:<cell>``) and writes
``WORKDIR/jax_serve.npz``: for each cell, `repro.train.step`'s prefill
and decode steps jitted with the in_shardings of
`repro/launch/dryrun.py` (params by `param_specs`, the batch by
`batch_specs`, the token by ``P(dp, None)``, the cache by `cache_specs`)
under ``jax.set_mesh``, compiled with ``xla_allow_excess_precision``
off (ROADMAP Queue 3 item 10): the last position's logits of the
prefill and of each of `SV_GEN` decode steps, and the cache's leaves
after the prefill and at the end, in ``jax.tree.leaves`` order. The f32
arm patches `layers.CDTYPE` to f32 and upcasts the weights.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from jax_sharding_oracle import _cfg, _exact_jit, _mesh, _weights
from repro.models import layers as L
from repro.models import model as M
from repro.models import sharding as SH
from repro.train import step as ST
from torch_dist_worker import SERVE_CELLS, SV_GEN, serve_cache_len


def serve_cell(cell, inp, out):
    arch, shape, arm, over = SERVE_CELLS[cell]
    cfg = _cfg(arch, over)
    L.CDTYPE = jnp.float32 if arm == "f32" else jnp.bfloat16
    params = _weights(inp, cell, cfg, arm)
    batch = {k: jnp.asarray(inp[f"b:{cell}:{k}"])
             for k in ("tokens", "frames", "patches")
             if f"b:{cell}:{k}" in inp}
    for k in ("frames", "patches"):
        if k in batch:
            batch[k] = batch[k].astype(L.CDTYPE)
    mesh = _mesh(shape)
    cache_len = serve_cache_len(cfg)
    pshard = SH.tree_shardings(mesh, SH.param_specs(cfg, mesh, params))
    bshard = SH.tree_shardings(mesh, SH.batch_specs(cfg, mesh, batch))
    dp = SH.data_axes(mesh)
    toks = np.asarray(inp[f"d:{cell}"])
    tshard = NamedSharding(mesh, P(dp, None))
    params, batch = jax.device_put((params, batch), (pshard, bshard))
    with jax.set_mesh(mesh):
        pre = _exact_jit(ST.make_prefill_step(cfg, cache_len=cache_len),
                         (pshard, bshard), (params, batch))
        logits, cache = pre(params, batch)
        cshard = SH.tree_shardings(mesh, SH.cache_specs(cfg, mesh, cache))
        cache = jax.device_put(cache, cshard)
        for i, t in enumerate(jax.tree.leaves(cache)):
            out[f"{cell}:cache0:{i}"] = np.asarray(t, np.float32)
        steps = [np.asarray(logits[:, -1], np.float32)]
        tok0 = jax.device_put(jnp.asarray(toks[:, :1]), tshard)
        dec = _exact_jit(ST.make_decode_step(cfg), (pshard, tshard, cshard),
                         (params, tok0, cache))
        for j in range(SV_GEN):
            tok = jax.device_put(jnp.asarray(toks[:, j:j + 1]), tshard)
            logits, cache = dec(params, tok, cache)
            cache = jax.device_put(cache, cshard)
            steps.append(np.asarray(logits[:, -1], np.float32))
    out[f"{cell}:logits"] = np.stack(steps)
    for i, t in enumerate(jax.tree.leaves(cache)):
        out[f"{cell}:cache:{i}"] = np.asarray(t, np.float32)


def main(workdir: str) -> None:
    wd = Path(workdir)
    inp = dict(np.load(wd / "inputs.npz"))
    out: dict = {}
    for cell in json.loads(str(inp["cells"])):
        serve_cell(cell, inp, out)
    np.savez(wd / "jax_serve.npz", **out)


if __name__ == "__main__":
    main(sys.argv[1])

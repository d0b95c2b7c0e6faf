"""The JAX package's sharded train step on forced host devices: the
oracle of tests/test_torch_sharding.py and tests/test_torch_sharded_train.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_sharding_oracle.py WORKDIR

It runs in a process of its own, because the test process must see the
one real CPU device (tests/conftest.py). It reads ``WORKDIR/inputs.npz``
(``cells``, a JSON list of `SHARDED_CELLS` names, and each cell's
weights ``w:<cell>:<path>`` and batch ``b:<cell>:<name>``, as
tests/torch_dist_worker.py reads them) and writes
``WORKDIR/jax_sharding.npz``: for each cell, one jitted
`repro.train.step.make_train_step` step (n_micro `SH_MICRO`, remat
`SH_REMAT`) under
``jax.set_mesh`` with params, moments and batch laid out by
`repro.models.sharding`'s specs, from zero moments: the loss, the grad
norm, and the params and moments after it, leaf by leaf in
``jax.tree.leaves`` order. The f32 arm patches `layers.CDTYPE` to f32 and
upcasts the weights; each step is compiled with
``xla_allow_excess_precision`` off (ROADMAP Queue 3 item 10).

Given ``ep_x``, it also runs granite's first MoE layer (`layers.moe_fwd`,
the expert-parallel ``shard_map``) on the (2, 2) mesh and records each
device's kept mask: ``jnp.cumsum`` is wrapped for the call, and its
operand, the body's masked one-hot, is sent out by ``jax.debug.callback``
with the device's coordinates; the mask is that one-hot's rows that
hold a 1 and whose rank is below the local capacity, as the body
computes it.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from repro import configs
from repro.models import layers as L
from repro.models import model as M
from repro.models import sharding as SH
from repro.optim import adamw
from repro.train import step as ST
from torch_dist_worker import (SH_AXES, SH_MICRO, SH_OPT, SH_REMAT,
                               SHARDED_CELLS)


def _cfg(arch, over, cf=None):
    cfg = dataclasses.replace(configs.get_reduced(arch), **over)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
    return cfg


def _mesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), SH_AXES)


def _weights(inp, cell, cfg, arm):
    shape = jax.eval_shape(lambda k: M.init_params(k, cfg),
                           jax.random.PRNGKey(1))

    def leaf(path, s):
        key = f"w:{cell}:{SH._path_str(path)}"
        return jnp.asarray(inp[key], jnp.float32 if arm == "f32"
                           else s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shape)


def _exact_jit(fn, shardings, args):
    """``fn`` jitted with ``shardings`` and compiled with XLA's
    ``xla_allow_excess_precision`` off, so that a bf16 value is rounded
    where the model rounds it (tests/test_torch_ssm.py's `_exact_jit`)."""
    return jax.jit(fn, in_shardings=shardings).lower(*args).compile(
        {"xla_allow_excess_precision": False})


def step_cell(cell, inp, out):
    arch, shape, arm, over = SHARDED_CELLS[cell]
    cfg = _cfg(arch, over)
    L.CDTYPE = jnp.float32 if arm == "f32" else jnp.bfloat16
    params = _weights(inp, cell, cfg, arm)
    batch = {k: jnp.asarray(inp[f"b:{cell}:{k}"])
             for k in ("tokens", "labels", "frames", "patches")
             if f"b:{cell}:{k}" in inp}
    for k in ("frames", "patches"):
        if k in batch:
            batch[k] = batch[k].astype(L.CDTYPE)
    mesh = _mesh(shape)
    ps = SH.param_specs(cfg, mesh, params)
    opt_specs = adamw.AdamWState(mu=ps, nu=ps, count=P())
    bs = SH.batch_specs(cfg, mesh, batch)
    fn = ST.make_train_step(cfg, n_micro=SH_MICRO, remat=SH_REMAT,
                            opt_cfg=adamw.AdamWConfig(**SH_OPT))
    shard = (SH.tree_shardings(mesh, ps), SH.tree_shardings(mesh, opt_specs),
             SH.tree_shardings(mesh, bs))
    args = jax.device_put((params, adamw.init(params), batch), shard)
    with jax.set_mesh(mesh):
        p2, o2, m = _exact_jit(fn, shard, args)(*args)
    out[f"{cell}:loss"] = np.asarray(m["loss"])
    out[f"{cell}:grad_norm"] = np.asarray(m["grad_norm"])
    for what, tree in (("params", p2), ("mu", o2.mu), ("nu", o2.nu)):
        for i, t in enumerate(jax.tree.leaves(tree)):
            out[f"{cell}:{what}:{i}"] = np.asarray(t, np.float32)


def ep_masks(inp, out):
    cfg = _cfg("granite-moe-1b-a400m", {})
    L.CDTYPE = jnp.float32
    params = _weights(inp, "moe-f32", cfg, "f32")
    p = jax.tree.map(lambda a: a[0], params["blocks"]["0"]["moe"])
    x = jnp.asarray(inp["ep_x"])
    mesh = _mesh((2, 2))
    seen = {}

    def record(onehot, d, m):
        seen[(int(d), int(m))] = np.asarray(onehot)

    real = jnp.cumsum

    def spy(a, axis=None, **kw):
        jax.debug.callback(record, a, jax.lax.axis_index("data"),
                           jax.lax.axis_index("model"))
        return real(a, axis=axis, **kw)

    jnp.cumsum = spy
    try:
        with jax.set_mesh(mesh):
            y, aux = jax.jit(lambda p_, x_: L.moe_fwd(p_, x_, cfg.moe))(p, x)
            jax.block_until_ready(y)
    finally:
        jnp.cumsum = real
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    T = x.shape[0] // mesh.shape["data"] * x.shape[1]
    cap = int(cfg.moe.capacity_factor * T * K / E + 0.999)
    for (d, m), onehot in seen.items():
        rank = ((np.cumsum(onehot, axis=0) - onehot) * onehot).sum(-1)
        out[f"ep:valid:{d}:{m}"] = onehot.any(-1) & (rank < cap)
    out["ep:out"] = np.asarray(y)
    out["ep:aux"] = np.asarray(aux)


def main(workdir: str) -> None:
    wd = Path(workdir)
    inp = dict(np.load(wd / "inputs.npz"))
    out: dict = {}
    for cell in json.loads(str(inp["cells"])):
        step_cell(cell, inp, out)
    if "ep_x" in inp:
        ep_masks(inp, out)
    np.savez(wd / "jax_sharding.npz", **out)


if __name__ == "__main__":
    main(sys.argv[1])

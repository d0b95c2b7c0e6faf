"""The inputs, the runs and the checks of the sharded train step's cells,
shared by tests/test_torch_sharding.py and tests/test_torch_sharded_train.py.

`run_cells` makes each cell's weights (JAX's ``init_params`` from
``PRNGKey(1)``, every leaf written as f32, which holds bf16 exactly) and
batch (numpy, seed 0; frame and patch stubs bf16-exact), then runs JAX's
sharded step (tests/jax_sharding_oracle.py, a subprocess on 4 forced host
devices) and the port's on 4 spawned gloo ranks
(tests/torch_dist_worker.py's ``sharded_train`` case) at the same time.

`check_cell` holds the port's step to JAX's:
  * f32 arm (JAX's ``CDTYPE`` patched to f32, the weights upcast in both):
    the loss within 1e-5, each leaf's gradient within 1e-4 relative
    (Frobenius) and each updated param within 1e-5 relative;
  * bf16 arm: the loss within 6e-2 and each leaf's gradient within
    `BF16_GRAD_RTOL` relative (tests/test_torch_train.py's tolerances).
The gradients are read from the first moments: one AdamW step from zero
moments makes ``mu = (1 - b1) * g * scale``, with ``scale = min(1, clip /
grad_norm)`` from each package's own grad norm, so ``g`` is recovered
exactly up to one f32 rounding in either package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

import torch_dist_worker as worker
from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import sharding as JSH
from repro.optim import adamw as jadamw

TESTS = Path(__file__).resolve().parent
BF16_GRAD_RTOL = 5e-2
ORACLE_TIMEOUT_S = 300.0


def _cfg(cell):
    arch, _, _, over = worker.SHARDED_CELLS[cell]
    import dataclasses
    return dataclasses.replace(jconfigs.get_reduced(arch), **over)


def _bf16_exact(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).bfloat16().float().numpy()


def cell_inputs(cells, *, ep: bool = False, placements: bool = False):
    """``inputs.npz``'s arrays for ``cells`` (and the EP layer's rows,
    and the placement checks)."""
    inp = {"cells": np.array(json.dumps(list(cells)))}
    for cell in cells:
        cfg = _cfg(cell)
        params = JM.init_params(jax.random.PRNGKey(1), cfg)
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            inp[f"w:{cell}:{JSH._path_str(path)}"] = np.asarray(
                leaf, np.float32)
        rng = np.random.default_rng(0)
        B, S = worker.SH_BATCH, worker.SH_SEQ
        toks = rng.integers(0, cfg.vocab, (B, S + 1))
        labels = toks[:, 1:].astype(np.int32)
        labels[0, :3] = -100                   # masked positions
        inp[f"b:{cell}:tokens"] = toks[:, :-1].astype(np.int32)
        inp[f"b:{cell}:labels"] = labels
        if cfg.family == "encdec":
            inp[f"b:{cell}:frames"] = _bf16_exact(rng.standard_normal(
                (B, cfg.encoder.n_ctx, cfg.encoder.d_frontend),
                dtype=np.float32))
        if cfg.family == "vlm":
            inp[f"b:{cell}:patches"] = _bf16_exact(rng.standard_normal(
                (B, cfg.encoder.n_ctx, cfg.d_model), dtype=np.float32))
    if ep:
        cfg = _cfg("moe-f32")
        inp["ep_x"] = np.random.default_rng(5).standard_normal(
            (worker.EP_ROWS, worker.SH_SEQ, cfg.d_model), dtype=np.float32)
    if placements:
        inp["placements"] = np.array(1)
    return inp


def run_cells(tmp_path_factory, cells, **kw):
    """(JAX's outputs, the port's rank-0 outputs, every rank's)."""
    inp = cell_inputs(cells, **kw)
    wd = tmp_path_factory.mktemp("sharding_oracle")
    np.savez(wd / "inputs.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"),
                                           str(TESTS)]))
    proc = subprocess.Popen(
        [sys.executable, str(TESTS / "jax_sharding_oracle.py"), str(wd)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = worker.spawn(tmp_path_factory.mktemp("sharding_ranks"),
                             "sharded_train", (2, 2), worker.SH_AXES,
                             timeout_s=240.0, **inp)
        log, _ = proc.communicate(timeout=ORACLE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    return dict(np.load(wd / "jax_sharding.npz")), ranks[0], ranks


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _grad(mu, gnorm) -> np.ndarray:
    opt = jadamw.AdamWConfig(**worker.SH_OPT)
    scale = min(1.0, opt.grad_clip / max(float(gnorm), 1e-12))
    return np.asarray(mu, np.float64) / ((1 - opt.b1) * scale)


def leaf_names(cell):
    shape = jax.eval_shape(lambda k: JM.init_params(k, _cfg(cell)),
                           jax.random.PRNGKey(1))
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(shape)[0]]


def check_cell(cell, jout, pout):
    """The port's step against JAX's at the cell's arm's tolerances;
    returns the port's and JAX's losses."""
    arm = worker.SHARDED_CELLS[cell][2]
    loss, jloss = float(pout[f"{cell}:loss"]), float(jout[f"{cell}:loss"])
    tol, grad_rtol = (1e-5, 1e-4) if arm == "f32" else (6e-2, BF16_GRAD_RTOL)
    assert abs(loss - jloss) <= tol, (cell, loss, jloss)
    for i, name in enumerate(leaf_names(cell)):
        g = _grad(pout[f"{cell}:mu:{i}"], pout[f"{cell}:grad_norm"])
        jg = _grad(jout[f"{cell}:mu:{i}"], jout[f"{cell}:grad_norm"])
        assert _rel(g, jg) <= grad_rtol, (cell, name, _rel(g, jg))
        if arm == "f32":
            rel = _rel(pout[f"{cell}:params:{i}"], jout[f"{cell}:params:{i}"])
            assert rel <= 1e-5, (cell, name, rel)
    return loss, jloss

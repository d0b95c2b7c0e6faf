"""The sharded prefill and decode steps against the JAX package's, on the
CPU: `train/step.py`'s `make_prefill_step`/`make_decode_step` with a
``mesh`` (`models/model.py`'s `prefill`/`decode_step` under
`layers.use_mesh`).

* Each family at --reduced size on (2, 2) in f32, the hybrid family
  (attention, the SSD and the MoE) in bf16 too; the grouped K/V
  heads that do not divide the model dim on (1, 4) (8 query heads over
  2 K/V heads: the query heads sharded, K/V whole, the cache split over
  positions; the same with granite's MoE; and 6 over 2, every head whole
  with a context-parallel prefill): JAX's jitted sharded steps on 4
  forced host devices (tests/jax_serve_oracle.py, a subprocess) beside 4
  gloo ranks (tests/torch_dist_worker.py's ``sharded_serve`` case), from
  the same weights, prompt and decode tokens. The last position's logits
  of the prefill and of each of 3 decode steps, and the whole cache after
  the prefill and at the end, agree within `F32_RTOL` relative
  (Frobenius) in the f32 arm (JAX's ``CDTYPE`` patched to f32, the
  weights upcast) and within `BF16_ATOL` in the bf16 arm (each step
  compiled with ``xla_allow_excess_precision`` off).
* A one-rank (1, 1) gloo mesh's sharded prefill and decode are bit-equal
  to the local steps for every family: each collective over a one-rank
  dim is the identity, and the MoE's global dispatch at one rank is the
  single-device one.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
import torch_sharded_cells as cells
from repro_torch import configs
from repro_torch.launch import input_specs as tin
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.train import step as tstep
from repro_torch.util.tree import tree_leaves
from test_torch_sharding import FAMILIES, _one_rank

CELLS = list(worker.SERVE_CELLS)
#: the f32 arm's relative (Frobenius) tolerance of logits and caches
F32_RTOL = 1e-5
#: the bf16 arm's absolute tolerance (tests/test_torch_models.py's)
BF16_ATOL = 6e-2
ORACLE_TIMEOUT_S = 300.0


def _inputs():
    import dataclasses

    import jax
    from repro import configs as jconfigs
    from repro.models import model as JM
    from repro.models import sharding as JSH
    inp = {"cells": np.array(json.dumps(CELLS))}
    for cell in CELLS:
        arch, _, _, over = worker.SERVE_CELLS[cell]
        cfg = worker.sharded_config(arch, over)
        params = JM.init_params(jax.random.PRNGKey(1), dataclasses.replace(
            jconfigs.get_reduced(arch), **over))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            inp[f"w:{cell}:{JSH._path_str(path)}"] = np.asarray(
                leaf, np.float32)
        rng = np.random.default_rng(3)
        B = worker.SV_BATCH
        inp[f"b:{cell}:tokens"] = rng.integers(
            0, cfg.vocab, (B, worker.SV_PROMPT)).astype(np.int32)
        inp[f"d:{cell}"] = rng.integers(
            0, cfg.vocab, (B, worker.SV_GEN)).astype(np.int32)
        if cfg.family == "encdec":
            inp[f"b:{cell}:frames"] = cells._bf16_exact(rng.standard_normal(
                (B, cfg.encoder.n_ctx, cfg.encoder.d_frontend),
                dtype=np.float32))
        if cfg.family == "vlm":
            inp[f"b:{cell}:patches"] = cells._bf16_exact(rng.standard_normal(
                (B, cfg.encoder.n_ctx, cfg.d_model), dtype=np.float32))
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's outputs, the port's rank-0 outputs)."""
    inp = _inputs()
    wd = tmp_path_factory.mktemp("serve_oracle")
    np.savez(wd / "inputs.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(cells.TESTS.parent / "src"),
                                           str(cells.TESTS)]))
    proc = subprocess.Popen(
        [sys.executable, str(cells.TESTS / "jax_serve_oracle.py"), str(wd)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ranks = worker.spawn(tmp_path_factory.mktemp("serve_ranks"),
                             "sharded_serve", (2, 2), worker.SH_AXES,
                             timeout_s=240.0, **inp)
        log, _ = proc.communicate(timeout=ORACLE_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    return dict(np.load(wd / "jax_serve.npz")), ranks[0]


def _check(got, want, arm, what):
    if arm == "f32":
        rel = cells._rel(got, want)
        assert rel <= F32_RTOL, (what, rel)
    else:
        err = float(np.max(np.abs(np.asarray(got, np.float64)
                                  - np.asarray(want, np.float64)),
                           initial=0.0))
        assert err <= BF16_ATOL, (what, err)


@pytest.mark.parametrize("cell", CELLS)
def test_sharded_serving_matches_jax(runs, cell):
    jout, pout = runs
    arm = worker.SERVE_CELLS[cell][2]
    for j, (got, want) in enumerate(zip(pout[f"{cell}:logits"],
                                        jout[f"{cell}:logits"])):
        _check(got, want, arm, f"{cell} logits of step {j}")
    n = sum(1 for k in jout if k.startswith(f"{cell}:cache:"))
    assert n and n == sum(1 for k in pout if k.startswith(f"{cell}:cache:"))
    for tag in ("cache0", "cache"):
        for i in range(n):
            _check(pout[f"{cell}:{tag}:{i}"], jout[f"{cell}:{tag}:{i}"], arm,
                   f"{cell} {tag} leaf {i}")


def _serve(cfg, params, batch, toks, mesh=None):
    """The prefill's logits and cache and each decode step's logits."""
    kw = {} if mesh is None else {"mesh": mesh, "device": "cpu"}
    pre = tstep.make_prefill_step(cfg, cache_len=worker.serve_cache_len(cfg),
                                  **kw)
    dec = tstep.make_decode_step(cfg, **kw)
    logits, cache = pre(params, batch)
    out = [logits] + tree_leaves(cache)
    for j in range(toks.shape[1]):
        logits, cache = dec(params, toks[:, j:j + 1], cache)
        out.append(logits)
    return out + tree_leaves(cache)


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_rank_sharded_serving_is_bit_equal_to_the_local_steps(arch):
    cfg = configs.get_reduced(arch)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8), generator=g,
                                     dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(2, cfg.encoder.n_ctx,
                                      cfg.encoder.d_frontend,
                                      generator=g).bfloat16()
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.encoder.n_ctx, cfg.d_model,
                                       generator=g).bfloat16()
    toks = torch.randint(0, cfg.vocab, (2, 3), generator=g,
                         dtype=torch.int32)
    local = _serve(cfg, M.init_params(1, cfg, "cpu"), batch, toks)
    with _one_rank():
        mesh = make_host_mesh((1, 1), ("data", "model"))
        specs = S.param_specs(cfg, mesh, tin.abstract_params(cfg))
        params = S.shard_tree(M.init_params(1, cfg, "cpu"), specs, mesh)
        got = _serve(cfg, params, batch, toks, mesh)
    assert len(got) == len(local)
    for a, b in zip(got, local):
        assert a.dtype == b.dtype and torch.equal(a, b)

"""The dry run (`repro_torch/launch/dryrun.py`), its op-level cost model
(`repro_torch/roofline/op_cost.py`), the roofline's third term
(`repro_torch/roofline/analysis.py`) and `input_specs.materialize`,
against the JAX package's, on the CPU.

* `model_flops_train`/`model_flops_fwd` of every arch x shape equal
  JAX's.
* The counterparts of tests/test_roofline.py: one matmul counts exactly
  2 n k m; a 20-step loop counts 20 times one step and nested loops the
  product of their trips (the port's loops run on the host, so each trip
  is counted as it runs); on a fake group of 128 ranks an all-gather, an
  all-reduce and a one-hop all-to-all (the port's ``ppermute``) give
  JAX's crafted numbers, 128 x 16 x 4, 2 x 16 x 4 and 16 x 4 bytes; a
  write into a slice of a stack counts the slice; the three roofline
  terms and their bottleneck, while the two-term calls keep their values.
* The dry run's fold of the microbatch loop into one traced trip, and its
  extension of two and three periods to a cell's, give the full trace's
  counts exactly at reduced size.
* `materialize` gives JAX's structure, shapes, dtypes and ranges on each
  family's reduced specs, and the same bits for the same seed.
* `trace_cell` on rank 0 of a fake group of 4, (2, 2), against
  `repro.launch.dryrun.lower_cell` and `hlo_cost.analyze` on 4 forced host
  devices (tests/jax_dryrun_oracle.py, a subprocess), for tinyllama,
  granite and mamba2 train, prefill and decode at seq 64, batch 4: the
  model FLOPs per device are equal, and the FLOPs per device agree as
  follows, each gap explained:

    - prefill, and the dense decode: equal. Every product is the same
      product on the same block.
    - train: JAX's count lies between the port's with no recompute and
      the port's with each period recomputed (tinyllama +8.0 % over JAX,
      granite +0.3 %, mamba2 +12.8 %). The port's remat
      (`torch.utils.checkpoint` a period) runs the whole period's forward
      again in the backward; JAX's policy
      (``dots_with_no_batch_dims_saveable``) keeps the products without
      batch dims (the projections, the MLP) and recomputes those with
      them (the attention's scores and ``p . v`` under flash's own
      checkpoints, the SSD's and the experts' products). Without remat
      the port counts 10.0 %, 21.6 % and 3.3 % below JAX.
    - mamba2 decode: the port counts ``2 B nh hd N`` more a layer. The
      state update's outer product ``x . B`` (an einsum with no
      contracted dim) is a batched matmul with a contraction of one in
      torch, which the flop registry counts, and an elementwise multiply
      in XLA, which ``hlo_cost`` does not.
    - granite decode: the port counts about half its experts' products
      more (`GRANITE_DECODE_SLACK`). At S == 1 JAX's dense dispatch
      runs under GSPMD, which splits the experts' products over the data
      ranks too (its all-to-alls and permutes carry the tokens), where
      the port's global dispatch (`layers._moe_fwd_global`) gathers the
      tokens and runs every slot of its experts on each data rank.

  The wire bytes by kind are printed. Prefill and dense decode send what
  GSPMD sends, kind by kind (the port issues one collective a leaf or
  op where XLA combines them, so its counts are larger). In training the
  port reduce-scatters each FSDP gradient where GSPMD all-reduces, and
  gathers its 16-bit weights as f32 (`collectives.gather_along`). At
  decode GSPMD moves granite's tokens (all-to-all, permute) where the
  port all-gathers the expert stacks' FSDP dim, and it permutes mamba2's
  conv state where the port gathers the B/C projections.
* One full-width cell, tinyllama-1.1b ``decode_32k`` on pod16x16, through
  ``python -m repro_torch.launch.dryrun`` in a subprocess: ``ok`` and
  JAX's record keys, less ``t_lower_s``, ``t_compile_s`` and
  ``xla_cost_analysis``, with ``t_trace_s``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax_dryrun_oracle as oracle
from repro import configs as jconfigs
from repro.launch import input_specs as jin
from repro.roofline import analysis as jra
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import input_specs as tin
from repro_torch.launch.mesh import init_fake_group, make_host_mesh
from repro_torch.obs.efficiency import WorkModel
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import op_cost

TESTS = Path(__file__).resolve().parent
ORACLE_TIMEOUT_S = 300.0
#: granite decode: the port's count over JAX's, as a share of half the
#: port's expert products (see the module's docstring)
GRANITE_DECODE_SLACK = 0.05


@pytest.fixture
def fake_group():
    """A fake process group for the test's duration (torn down after)."""
    def start(n):
        init_fake_group(n)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


# -- model FLOPs --------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.list_archs())
def test_model_flops_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert cfg.active_param_count() == jcfg.active_param_count()
    for shape in configs.shapes_for(cfg):
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        n = cfg.active_param_count()
        assert ra.model_flops_train(n, tokens) == jra.model_flops_train(
            n, tokens)
        assert ra.model_flops_fwd(n, tokens) == jra.model_flops_fwd(n, tokens)


# -- the cost model on known programs -----------------------------------------

def test_single_matmul_flops():
    n, k, m = 256, 512, 128
    a, b = torch.zeros(n, k), torch.zeros(k, m)
    c, _, _ = op_cost.analyze(lambda: a @ b)
    assert c.flops == 2.0 * n * k * m
    assert c.flops_by_dtype == {"f32": 2.0 * n * k * m}
    c, _, _ = op_cost.analyze(lambda: a.bfloat16() @ b.bfloat16())
    assert c.flops_by_dtype == {"bf16": 2.0 * n * k * m}


def test_loops_count_each_trip_and_nested_loops_their_product():
    n = 128
    x, w = torch.zeros(4, n), torch.zeros(n, n)

    def body(h):
        return torch.tanh(h @ w)

    one, _, _ = op_cost.analyze(body, x)

    def loop(h, trips):
        for _ in range(trips):
            h = body(h)
        return h

    c, _, _ = op_cost.analyze(loop, x, 20)
    assert c.flops == 20 * 2.0 * 4 * n * n == 20 * one.flops
    assert c.bytes == 20 * one.bytes

    def nested(h):
        for _ in range(5):
            h = loop(h, 7)
        return h

    c, _, _ = op_cost.analyze(nested, x)
    assert c.flops == 5 * 7 * one.flops


def test_collectives_on_a_fake_group_give_jax_crafted_numbers(fake_group):
    fake_group(128)

    def run():
        p = torch.zeros(16)
        parts = [torch.empty_like(p) for _ in range(128)]
        dist.all_gather(parts, p)
        dist.all_reduce(p)
        out = torch.empty(16)
        dist.all_to_all_single(out, p,
                               [16 * (r == 127) for r in range(128)],
                               [16 * (r == 1) for r in range(128)])

    c, _, _ = op_cost.analyze(run)
    assert c.counts == {"all-gather": 1, "all-reduce": 1,
                        "collective-permute": 1}
    assert c.wire_by_kind["all-gather"] == 128 * 16 * 4
    assert c.wire_by_kind["all-reduce"] == 2 * 16 * 4
    assert c.wire_by_kind["collective-permute"] == 16 * 4
    # 128 ranks span 16 nodes of 8 cards: every byte crosses the network
    assert c.net_wire == c.wire


def test_slice_writes_count_the_slice_not_the_buffer():
    L_, S_, D_ = 16, 64, 32
    stack = torch.zeros(L_, S_, D_)
    row = S_ * D_ * 4

    def fill():
        for i in range(L_):
            stack[i] = torch.ones(S_, D_)

    c, _, _ = op_cost.analyze(fill)
    # each step: ones written, then read and written into the slice
    assert c.bytes == L_ * 3 * row
    cache = torch.zeros(2, 1024, 4, 8)
    new = torch.ones(2, 1, 4, 8)
    at = torch.tensor([5])
    c, _, _ = op_cost.analyze(lambda: cache.index_copy_(1, at, new))
    assert c.bytes == 2 * new.numel() * 4 + at.numel() * 8


def test_roofline_terms_and_bottleneck():
    r = ra.roofline_terms(67e12, 3.35e12 * 2, bf16_flops=989e12,
                          nvlink_bytes=450e9 * 0.5, net_bytes=50e9 * 0.25,
                          model_flops=989e12 * 1.5)
    assert r.compute_s == pytest.approx(2.0)
    assert r.memory_s == pytest.approx(2.0)
    assert r.collective_s == pytest.approx(0.75)
    assert r.bottleneck == "memory"
    assert r.useful_ratio == pytest.approx(989e12 * 1.5 / (67e12 + 989e12))
    assert r.roofline_fraction() == pytest.approx(0.75)
    assert ra.roofline_terms(0.0, 1.0, net_bytes=1.0).bottleneck \
        == "collective"
    # the two-term calls keep their values
    old = ra.roofline_terms(67e12, 3.35e12, tf32_flops=495e12)
    assert (old.compute_s, old.memory_s, old.bottleneck, old.step_time_s()) \
        == (2.0, 1.0, "compute", 2.0)
    assert old.collective_s == 0.0 and old.roofline_fraction() is None
    assert ra.roofline_terms(0.0, 1.0).bottleneck == "memory"
    # obs/efficiency.py's per-round bound is still the two-term one
    rw = WorkModel(784, 50).round_work(5000, dt_s=1e-3)
    assert rw.bound_s == max(rw.flops / 495e12, rw.hbm_bytes / 3.35e12)
    assert rw.utilization == rw.bound_s / 1e-3


def test_extension_over_periods_and_microbatches_is_the_full_count(
        fake_group):
    fake_group(4)
    mesh = make_host_mesh((2, 2), ("data", "model"))
    cfg = dataclasses.replace(configs.get_reduced("tinyllama-1.1b"),
                              n_layers=5)
    for shape in (ShapeConfig("t", 8, 4, "train"),
                  ShapeConfig("p", 8, 2, "prefill"),
                  ShapeConfig("d", 8, 2, "decode")):
        ext = D.cell_cost(cfg, shape, mesh)[0]
        full = D._trace(cfg, shape, mesh, fold=False)[0]
        for f in ("flops", "bytes", "wire", "net_wire", "wire_by_kind",
                  "flops_by_dtype", "counts"):
            assert getattr(ext, f) == getattr(full, f), (shape.kind, f)
    assert D.n_micro_for(cfg, ShapeConfig("t", 8, 4, "train"), mesh) == 2


# -- materialize -------------------------------------------------------------

def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_paths(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-1b-a400m",
                                  "mamba2-2.7b", "jamba-v0.1-52b",
                                  "whisper-tiny", "internvl2-76b"])
def test_materialize_has_jax_structure_shapes_dtypes_and_ranges(arch):
    shape = ShapeConfig("r", 16, 2, "decode")
    cfg, jcfg = configs.get_reduced(arch), jconfigs.get_reduced(arch)
    trees = {"train": (tin.train_batch_specs(cfg, shape),
                       jin.train_batch_specs(jcfg, shape)),
             "decode": (tin.decode_specs(cfg, shape),
                        jin.decode_specs(jcfg, shape))}
    for name, (spec, jspec) in trees.items():
        got = _paths(tin.materialize(spec, seed=3, device="cpu"))
        want = _paths(jax_tree_np(jin.materialize(jspec, seed=3)))
        assert sorted(got) == sorted(want), name
        for p, t in got.items():
            w = want[p]
            assert tuple(t.shape) == w.shape, (name, p)
            assert str(t.dtype).split(".")[-1] == str(w.dtype), (name, p)
            if t.dtype.is_floating_point:
                assert torch.isfinite(t.float()).all(), (name, p)
            else:
                assert int(t.min()) >= 0 and int(t.max()) < 128, (name, p)
        again = _paths(tin.materialize(spec, seed=3, device="cpu"))
        assert all(torch.equal(again[p], t) for p, t in got.items())
        other = _paths(tin.materialize(spec, seed=4, device="cpu"))
        assert not all(torch.equal(other[p], t) for p, t in got.items()
                       if t.numel() > 1)


def jax_tree_np(tree):
    """JAX's tree as nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_tree_np(v) for k, v in tree.items()}
    return np.asarray(tree)


# -- the dry run against JAX's at reduced size -------------------------------

@pytest.fixture(scope="module")
def dry(tmp_path_factory):
    """(JAX's records by ``arch:kind``, the port's (cost, model FLOPs per
    device, the cost without recompute for train) by the same keys)."""
    out = tmp_path_factory.mktemp("dry_oracle") / "jax_dry.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(TESTS.parent / "src"),
                                           str(TESTS)]))
    proc = subprocess.Popen(
        [sys.executable, str(TESTS / "jax_dryrun_oracle.py"), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = {}
    try:
        init_fake_group(4)
        mesh = make_host_mesh(oracle.DRY_MESH, ("data", "model"))
        for arch, kind in oracle.DRY_CELLS:
            cfg = configs.get_reduced(arch)
            shape = oracle.shape_of(kind)
            cost, _, mf, _, _ = D.cell_cost(cfg, shape, mesh)
            flat = None
            if kind == "train":
                flat = D._trace(cfg, shape, mesh, remat=False,
                                fold=False)[0]
            port[f"{arch}:{kind}"] = (cost, mf / D._world(mesh), flat)
        log, _ = proc.communicate(timeout=ORACLE_TIMEOUT_S)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, log
    return json.loads(out.read_text()), port


def _expert_products(cfg, rows_global):
    """The FLOPs of one rank's experts' three products in the global
    dispatch at decode, over all layers, on (2, 2)."""
    moe = cfg.moe
    cap = int(moe.capacity_factor * rows_global * moe.top_k / moe.n_experts
              + 0.999)
    e_loc = moe.n_experts // oracle.DRY_MESH[1]
    return cfg.n_layers * 3 * 2.0 * e_loc * cap * cfg.d_model \
        * moe.d_expert_ff


@pytest.mark.parametrize("arch,kind", oracle.DRY_CELLS)
def test_dry_run_matches_jax_at_reduced_size(dry, arch, kind):
    jrec, port = dry
    want = jrec[f"{arch}:{kind}"]
    cost, mf, flat = port[f"{arch}:{kind}"]
    print(f"{arch} {kind}: port wire {cost.wire_by_kind} "
          f"counts {cost.counts}; JAX wire {want['wire_by_kind']} "
          f"counts {want['counts']}")
    assert mf == want["model_flops_per_device"]
    cfg = configs.get_reduced(arch)
    got, jf = cost.flops, want["flops"]
    if kind == "prefill" or (kind == "decode" and cfg.family == "dense"):
        assert got == jf
    elif kind == "train":
        assert flat.flops <= jf <= got, (flat.flops, jf, got)
    elif cfg.family == "ssm":
        s = cfg.ssm
        nh_loc = s.expand * cfg.d_model // s.head_dim // oracle.DRY_MESH[1]
        rows = oracle.DRY_BATCH // oracle.DRY_MESH[0]
        assert got - jf == cfg.n_layers * 2.0 * rows * nh_loc \
            * s.head_dim * s.d_state
    else:
        half = _expert_products(cfg, oracle.DRY_BATCH) / 2
        assert abs(got - jf - half) <= GRANITE_DECODE_SLACK * half, \
            (got, jf, half)


# -- one full-width cell, and the import -------------------------------------

def test_full_width_decode_cell_gives_jax_record_keys(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(TESTS.parent / "src"))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch.distributed as dist\n"
         "import repro_torch.launch.dryrun as d\n"
         "assert not dist.is_initialized(), 'import started a group'\n"
         "d.main()",
         "--arch", "tinyllama-1.1b", "--shape", "decode_32k",
         "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[OK ] tinyllama-1.1b__decode_32k__pod16x16" in proc.stdout
    rec = json.loads(
        (tmp_path / "tinyllama-1.1b__decode_32k__pod16x16.json").read_text())
    jax_keys = {"cell", "arch", "shape", "mesh", "axes", "kind", "ok",
                "t_lower_s", "t_compile_s", "flops_per_device",
                "hbm_bytes_per_device", "wire_bytes_per_device",
                "xla_cost_analysis", "collectives", "collective_counts",
                "model_flops_per_device", "memory", "roofline"}
    left_out = {"t_lower_s", "t_compile_s", "xla_cost_analysis"}
    assert rec["ok"] is True
    assert jax_keys - left_out <= set(rec) and "t_trace_s" in rec
    assert {"storage_bytes_analytic", "peak_bytes"} <= set(rec["memory"])
    assert set(rec["roofline"]) == {"compute_s", "memory_s", "collective_s",
                                    "bottleneck", "useful_ratio",
                                    "roofline_fraction"}
    assert rec["mesh"] == [16, 16] and rec["axes"] == ["data", "model"]
    assert rec["memory"]["fits_hbm"] is True

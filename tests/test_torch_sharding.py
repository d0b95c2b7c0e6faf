"""The port's sharding rules, layouts and mesh hooks against the JAX
package's, on the CPU: `repro_torch.models.sharding`,
`repro_torch.launch.input_specs`, `layers.constrain`/`use_mesh` and the
sharded train step on one rank.

* `param_specs`, `batch_specs` (the train batch at train_4k) and
  `cache_specs` (the decode cache at decode_32k) equal JAX's, leaf for
  leaf and path for path, for all 10 architectures at full width on
  (16, 16), (2, 16, 16), (2, 2) and (1, 4) meshes: JAX's on an
  ``AbstractMesh``, the port's from the ``(names, sizes)`` pair, with no
  process group; the abstract params (meta tensors) have JAX's paths,
  shapes and dtypes.
* `placements` of multi-axis entries, and its refusal of an order
  DTensor cannot express (DTensor's own layout of them is held on gloo
  ranks in tests/test_torch_sharded_train.py).
* Without a mesh `constrain` is the identity and the mesh hooks change no
  bit of a reduced step; a one-rank gloo (1, 1) mesh's sharded step is
  bit-equal to the local step for every family.
* The sharded step against JAX's on 4 forced host devices
  (tests/torch_sharded_cells.py, whose docstring states the tolerances)
  for the dense, moe and ssm families at --reduced size on (2, 2), both
  arms, and the context-parallel cell on (1, 4); the granite EP layer's
  kept masks on (2, 2) bit-equal to JAX's per shard, its f32 step
  matching JAX's sharded loss and not the dense dispatch's. The hybrid,
  encdec and vlm families are in tests/test_torch_sharded_train.py.
"""
import dataclasses
import functools
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as P

import torch_dist_worker as worker
import torch_sharded_cells as cells
from repro import configs as jconfigs
from repro.configs.base import DECODE_32K as J_DECODE, TRAIN_4K as J_TRAIN
from repro.launch import input_specs as jin
from repro.models import sharding as JSH
from repro_torch import configs
from repro_torch.configs.base import DECODE_32K, TRAIN_4K
from repro_torch.launch import input_specs as tin
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.util.tree import tree_leaves, tree_map

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
CELLS = ["dense-f32", "dense-bf16", "moe-f32", "moe-bf16", "ssm-f32",
         "ssm-bf16", "seqpar-f32"]
FAMILIES = ["tinyllama-1.1b", "granite-moe-1b-a400m", "mamba2-2.7b",
            "jamba-v0.1-52b", "whisper-tiny", "internvl2-76b"]


# -- the rules at full width --------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    return jin.abstract_params(jconfigs.get_config(arch))


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    return tin.abstract_params(configs.get_config(arch))


def _jax_flat(tree):
    return {JSH._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))[0]}


def _port_flat(tree):
    out = {}
    S.tree_map_with_path(
        lambda p, s: out.__setitem__(S._path_str(p), tuple(s)), tree)
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(configs.ARCHS))
def test_specs_equal_jax_at_full_width(arch, mesh):
    sizes, names = MESHES[mesh]
    am = AbstractMesh(sizes, names)
    desc = (names, sizes)
    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    jp, tp = _jax_abstract(arch), _port_abstract(arch)
    assert ({JSH._path_str(k): (tuple(v.shape), str(v.dtype)) for k, v in
             jax.tree_util.tree_flatten_with_path(jp)[0]}
            == {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in _port_flat_leaves(tp).items()})
    assert all(t.device.type == "meta" for t in tree_leaves(tp))
    assert _port_flat(S.param_specs(cfg, desc, tp)) == _jax_flat(
        JSH.param_specs(jcfg, am, jp))
    jb, tb = (jin.train_batch_specs(jcfg, J_TRAIN),
              tin.train_batch_specs(cfg, TRAIN_4K))
    assert _port_flat(S.batch_specs(cfg, desc, tb)) == _jax_flat(
        JSH.batch_specs(jcfg, am, jb))
    jc, tc = (jin.decode_specs(jcfg, J_DECODE)["cache"],
              tin.decode_specs(cfg, DECODE_32K)["cache"])
    assert _port_flat(S.cache_specs(cfg, desc, tc)) == _jax_flat(
        JSH.cache_specs(jcfg, am, jc))
    assert S.activation_spec(desc, cfg) == tuple(JSH.activation_spec(am,
                                                                      jcfg))
    assert (S.tp_ok(cfg, desc), S.kv_tp_ok(cfg, desc)) == (
        JSH.tp_ok(jcfg, am), JSH.kv_tp_ok(jcfg, am))


def _port_flat_leaves(tree):
    out = {}
    S.tree_map_with_path(lambda p, t: out.__setitem__(S._path_str(p), t),
                         tree)
    return out


def test_rules_read_a_device_mesh_as_its_description():
    """A `DeviceMesh` (one gloo rank) and the plain pair give the same
    specs."""
    cfg = configs.get_reduced("granite-moe-1b-a400m")
    params = tin.abstract_params(cfg)
    with _one_rank():
        mesh = make_host_mesh((1, 1), ("data", "model"))
        assert S.describe(mesh) == S.MeshDesc(("data", "model"), (1, 1))
        assert S.param_specs(cfg, mesh, params) == S.param_specs(
            cfg, (("data", "model"), (1, 1)), params)


# -- placements ---------------------------------------------------------------

def test_placements_of_multi_axis_entries():
    from torch.distributed.tensor import Replicate, Shard
    pdm = (("pod", "data", "model"), (2, 16, 16))
    assert S.placements((("pod", "data"), None), pdm) == [
        Shard(0), Shard(0), Replicate()]
    assert S.placements((None, ("data", "model")), pdm) == [
        Replicate(), Shard(1), Shard(1)]
    assert S.placements(("model", "data"), (("data", "model"), (2, 2))) == [
        Shard(1), Shard(0)]
    assert S.placements((None, None), (("data", "model"), (2, 2))) == [
        Replicate(), Replicate()]
    with pytest.raises(ValueError, match="order"):
        S.placements((("model", "data"), None), (("data", "model"), (2, 2)))
    with pytest.raises(ValueError, match="shards two dims"):
        S.placements(("data", "data"), (("data", "model"), (2, 2)))


# -- constrain and the one-rank step ------------------------------------------

def test_constrain_is_the_identity_without_a_mesh():
    x = torch.randn(2, 3, 4)
    for spec in [("dp", None, None), ("dp", None, "tp"), (None, "tp", None)]:
        assert L.constrain(x, *spec) is x
    assert L._ambient_mesh() is None and L.dp_axes() == ()
    p = {"w": x}
    assert L.gathered(p, "blocks", stacked=True) is p
    with L.use_mesh(None):
        assert L.constrain(x, "dp", None, None) is x


def _batch(cfg, seed=0, B=4, S_=16):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S_ + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(B, cfg.encoder.n_ctx,
                                      cfg.encoder.d_frontend).bfloat16()
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(B, cfg.encoder.n_ctx,
                                       cfg.d_model).bfloat16()
    return batch


def _steps(cfg, batch, n=2, **kw):
    params = M.init_params(1, cfg, "cpu")
    opt = adamw.init(params)
    step = tstep.make_train_step(cfg, n_micro=2, **kw)
    losses = []
    for _ in range(n):
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"])
    return tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(
        opt.nu) + [opt.count] + losses


def _bit_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "jamba-v0.1-52b"])
def test_mesh_hooks_change_no_bit_without_a_mesh(arch, monkeypatch):
    """Two steps with `constrain` and `gathered` replaced by pure
    identities give the bits of the real ones."""
    cfg = configs.get_reduced(arch)
    batch = _batch(cfg)
    real = _steps(cfg, batch, device="cpu")
    monkeypatch.setattr(L, "constrain", lambda x, *spec: x)
    monkeypatch.setattr(L, "gathered", lambda tree, prefix, **kw: tree)
    assert _bit_equal(_steps(cfg, batch, device="cpu"), real)


class _one_rank:
    """A one-rank gloo group in this process for the block's duration."""

    def __enter__(self):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)

    def __exit__(self, *exc):
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_rank_sharded_step_is_bit_equal_to_the_local_step(arch):
    """On a (1, 1) gloo mesh the sharded step (its params laid out by
    `param_specs`, its batch by `batch_specs`) gives the local step's
    params, moments, count and losses bit for bit over 2 steps: every
    collective over a one-rank dim is the identity, and the expert-
    parallel dispatch over one model rank is the dense one."""
    cfg = configs.get_reduced(arch)
    batch = _batch(cfg)
    local = _steps(cfg, batch, device="cpu")
    with _one_rank():
        mesh = make_host_mesh((1, 1), ("data", "model"))
        specs = S.param_specs(cfg, mesh, tin.abstract_params(cfg))
        params = S.shard_tree(M.init_params(1, cfg, "cpu"), specs, mesh)
        opt = adamw.init(params)
        step = tstep.make_train_step(cfg, n_micro=2, mesh=mesh, device="cpu")
        losses = []
        for _ in range(2):
            params, opt, m = step(params, opt, S.shard_tree(
                batch, S.batch_specs(cfg, mesh, batch), mesh))
            losses.append(m["loss"])
    got = tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(
        opt.nu) + [opt.count] + losses
    assert _bit_equal(got, local)


def test_sharded_step_asked_for_the_card_raises_without_one():
    cfg = configs.get_reduced("tinyllama-1.1b")
    with _one_rank():
        mesh = make_host_mesh((1, 1), ("data", "model"))
        with pytest.raises(RuntimeError, match="cuda"):
            tstep.make_train_step(cfg, mesh=mesh)


def test_sharded_prefill_and_decode_raise():
    """The sharded serving steps run on their device, as the sharded train
    step does: asked for the card they raise without one, and a step
    given tensors on another device than its own raises. (They no longer
    refuse a mesh: tests/test_torch_sharded_serve.py holds them to JAX.)"""
    cfg = configs.get_reduced("tinyllama-1.1b")
    params = M.init_params(1, cfg, "cpu")
    with _one_rank():
        mesh = make_host_mesh((1, 1), ("data", "model"))
        with pytest.raises(RuntimeError, match="cuda"):
            tstep.make_prefill_step(cfg, cache_len=8, mesh=mesh)
        with pytest.raises(RuntimeError, match="cuda"):
            tstep.make_decode_step(cfg, mesh=mesh)
        pre = tstep.make_prefill_step(cfg, cache_len=8, mesh=mesh,
                                      device="meta")
        with pytest.raises(ValueError, match="runs on meta"):
            pre(params, {"tokens": torch.zeros(1, 4, dtype=torch.int32)})


def test_grouped_kv_heads_that_do_not_divide_the_model_dim_raise(
        monkeypatch):
    """Query heads that shard over "model" with K/V heads that do not
    (8 heads, 2 K/V heads, 4 model ranks) no longer raise: K and V are
    whole on every rank (JAX's constraint drops "tp" on them) and each
    rank's 2 query heads read their group's K/V head."""
    cfg = dataclasses.replace(configs.get_reduced("tinyllama-1.1b"),
                              n_heads=8, n_kv_heads=2)
    p = L.Local(wq=torch.zeros(1))
    p.tp = frozenset({"wq"})
    monkeypatch.setattr(L, "_size", lambda axis: 4)
    assert L._heads_sharded(p, cfg) and L._kv_whole(cfg)
    k = torch.arange(2.0).reshape(1, 1, 2, 1).expand(1, 3, 2, 1)
    for rank, group in ((0, 0), (1, 0), (2, 1), (3, 1)):
        monkeypatch.setattr(L.C, "axis_index", lambda mesh, ax, r=rank: r)
        kq, vq = L._group_kv(torch.zeros(1, 3, 2, 1), k, k, cfg)
        assert kq.shape == (1, 3, 1, 1) and float(kq[0, 0, 0, 0]) == group


# -- the sharded step against JAX's -------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cells.run_cells(tmp_path_factory, CELLS, ep=True)


@pytest.mark.parametrize("cell", CELLS)
def test_sharded_step_matches_jax(runs, cell):
    cells.check_cell(cell, runs[0], runs[1])


def test_ep_kept_masks_are_jax_bits_per_shard(runs):
    """granite's first MoE layer on (2, 2): each (data, model) rank's kept
    mask over its own tokens (T_local * K rows, local capacity) equals
    JAX's in that shard bit for bit; the whole output within f32
    tolerance, the aux loss (averaged over "data") within 1e-6."""
    jout, _, ranks = runs
    for r, rank in enumerate(ranks):
        want = jout[f"ep:valid:{r // 2}:{r % 2}"]
        np.testing.assert_array_equal(rank["ep:valid"], want)
    assert 0 < ranks[0]["ep:valid"].sum() < ranks[0]["ep:valid"].size
    assert cells._rel(ranks[0]["ep:out"], jout["ep:out"]) <= 1e-5
    assert abs(float(ranks[0]["ep:aux"]) - float(jout["ep:aux"])) <= 1e-6


def test_ep_at_dp_2_is_not_the_dense_dispatch(runs):
    """The moe f32 cell's loss matches JAX's sharded loss (`check_cell`)
    and is not the dense dispatch's: the same step on one device (the
    port's local step, which JAX's unsharded step matches) drops other
    (token, choice) pairs."""
    cfg = worker.sharded_config("granite-moe-1b-a400m", {})
    inp = cells.cell_inputs(["moe-f32"])
    params = tree_map(lambda t: t.float(), worker._sh_params(
        inp, "moe-f32", "f32")[1])
    step = tstep.make_train_step(cfg, n_micro=worker.SH_MICRO,
                                 remat=worker.SH_REMAT,
                                 opt_cfg=adamw.AdamWConfig(**worker.SH_OPT))
    batch = {k: torch.from_numpy(inp[f"b:moe-f32:{k}"])
             for k in ("tokens", "labels")}
    dense = float(step(params, adamw.init(params), batch)[2]["loss"])
    loss = float(runs[1]["moe-f32:loss"])
    assert abs(loss - float(runs[0]["moe-f32:loss"])) <= 1e-5
    assert abs(loss - dense) > 1e-3, (loss, dense)


def test_ep_equals_the_dense_dispatch_where_nothing_drops(runs):
    """At dp = 1 (a (1, 4) mesh) and capacity factor `EP_NODROP_CF`,
    where no (token, choice) pair is dropped, the EP dispatch's output
    and aux loss equal the dense dispatch's on the same tokens within f32
    tolerance (the combine's terms summed over "model" in another
    order)."""
    ranks = runs[2]
    cfg = worker.sharded_config("granite-moe-1b-a400m", {},
                                worker.EP_NODROP_CF)
    inp = cells.cell_inputs(["moe-f32"], ep=True)
    params = worker._sh_params(inp, "moe-f32", "f32")[1]
    p = {k: v[0] for k, v in params["blocks"]["0"]["moe"].items()}
    out, aux = L.moe_fwd(p, torch.from_numpy(inp["ep_x"]), cfg.moe)
    # each (token, choice) kept by exactly one model rank: its expert's
    kept = np.sum([rank["ep_nodrop:valid"] for rank in ranks], axis=0)
    assert (kept == 1).all()
    for rank in ranks:
        assert cells._rel(rank["ep_nodrop:out"], out.numpy()) <= 1e-6
        assert abs(float(rank["ep_nodrop:aux"]) - float(aux)) <= 1e-6

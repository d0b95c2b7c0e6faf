"""The port's checkpoint store against the JAX package's, on the CPU.

First the cases of tests/test_checkpoint.py against
`repro_torch.checkpoint.CheckpointStore`: round trip (bf16 leaf
included), keep-N, background writes, checksums, crashed writers,
same-step overwrites, legacy dirs, tmp reaping, `clear` and
`extra.json`. Then the two packages on the same state: the local
engine's capture writes the same manifest keys, shapes, dtypes and leaf
bytes in both, a checkpoint written by either restores in the other
with equal bits, and a bfloat16 leaf survives the trip both ways.
"""
import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.api.engines.local import LocalEngine as JEngine
from repro.checkpoint.store import CheckpointStore as JStore
from repro_torch.api import CheckpointConfig, FitConfig
from repro_torch.api.engines.local import LocalEngine
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.state import init_state


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(rng.normal(size=(4,))).to(
                torch.bfloat16),
                "step": torch.tensor(7, dtype=torch.int32)}}


def zeros_like(t):
    return {"w": torch.zeros_like(t["w"]),
            "nested": {"b": torch.zeros_like(t["nested"]["b"]),
                       "step": torch.zeros_like(t["nested"]["step"])}}


def leaves(t):
    return [t["nested"]["b"], t["nested"]["step"], t["w"]]


def assert_same(a, b):
    for u, v in zip(leaves(a), leaves(b)):
        assert u.dtype == v.dtype and torch.equal(u, v)


# ---------------------------------------------------------------------------
# the store alone (the cases of tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("background", [False, True])
def test_roundtrip(tmp_path, background):
    store = CheckpointStore(tmp_path, keep=3)
    t = tree(5)
    store.save(10, t, background=background)
    store.wait()
    assert store.latest_step() == 10
    assert_same(store.restore(zeros_like(t)), t)


def test_background_save_writes_the_snapshot(tmp_path):
    """The leaves are copied before `save` returns: changing the tensors
    afterwards does not change what is written."""
    store = CheckpointStore(tmp_path)
    t = tree(1)
    want = t["w"].clone()
    store.save(1, t, background=True)
    t["w"].add_(1.0)
    store.wait()
    assert torch.equal(store.restore(zeros_like(t))["w"], want)


def test_keep_n_gc(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, tree(s))
    assert store.steps() == [3, 4]


def test_checksum_detects_corruption(tmp_path):
    store = CheckpointStore(tmp_path)
    t = tree()
    store.save(1, t)
    target = next(store._step_dirs()[1].glob("arr_*.npy"))
    arr = np.load(target).copy()
    arr.reshape(-1).view(np.uint8)[0] ^= 0xFF
    np.save(target, arr)
    with pytest.raises(IOError):
        store.restore(zeros_like(t))


def test_crashed_tmp_dir_is_ignored(tmp_path):
    store = CheckpointStore(tmp_path)
    t = tree()
    store.save(1, t)
    fake = tmp_path / "step_000000002.tmp-9999"
    fake.mkdir()
    (fake / "garbage").write_text("x")
    assert store.latest_step() == 1
    assert_same(store.restore(zeros_like(t)), t)


def test_missing_leaf_raises(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError):
        store.restore({"a": torch.zeros(2), "b": torch.zeros(3)})


def test_crash_during_overwrite_keeps_previous(tmp_path, monkeypatch):
    store = CheckpointStore(tmp_path)
    t1 = tree(1)
    store.save(5, t1)

    def crashing_rename(src, dst):
        raise OSError("simulated crash before the atomic rename")

    monkeypatch.setattr(os, "rename", crashing_rename)
    with pytest.raises(OSError):
        store.save(5, tree(2))
    monkeypatch.undo()
    assert store.latest_step() == 5
    assert_same(store.restore(zeros_like(t1)), t1)


def test_overwrite_same_step_newest_wins(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(3, tree(1))
    t2 = tree(2)
    store.save(3, t2)
    assert store.steps() == [3]
    assert_same(store.restore(zeros_like(t2)), t2)
    assert len([p for p in tmp_path.glob("step_*")
                if ".tmp-" not in p.name]) == 1


def test_legacy_unversioned_dir_still_restorable(tmp_path):
    store = CheckpointStore(tmp_path)
    t1 = tree(1)
    store.save(2, t1)
    legacy = tmp_path / "step_000000002"
    os.rename(store._step_dirs()[2], legacy)
    assert store.steps() == [2]
    assert_same(store.restore(zeros_like(t1)), t1)
    t2 = tree(9)
    store.save(2, t2)                     # a versioned rewrite wins
    assert_same(store.restore(zeros_like(t2)), t2)
    assert not legacy.exists()


def test_gc_reaps_stale_tmp_dirs(tmp_path):
    store = CheckpointStore(tmp_path)
    stale = tmp_path / "step_000000007.v123.tmp-4242"
    stale.mkdir()
    old = time.time() - 3600
    os.utime(stale, (old, old))
    fresh = tmp_path / "step_000000008.v456.tmp-4242"
    fresh.mkdir()
    store.save(9, tree())
    assert not stale.exists() and fresh.exists()
    assert store.steps() == [9]


def test_clear_removes_all_checkpoints(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, tree(1))
    store.save(2, tree(2))
    store.clear()
    assert store.steps() == [] and store.latest_step() is None


def test_extra_json_roundtrip(tmp_path):
    store = CheckpointStore(tmp_path)
    extra = {"loop": {"b_global": 512, "t_work": 1.5}, "config": {"k": 8}}
    store.save(4, tree(), extra=extra)
    assert store.read_extra() == extra == store.read_extra(4)
    store.save(5, tree())
    assert store.read_extra(5) is None


def test_kmeans_state_roundtrip_on_a_device(tmp_path):
    """A whole `KMeansState` (a dataclass tree with a None subtree)
    restores onto the device asked for, with its dtypes."""
    X = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 8)).astype(np.float32))
    s = init_state(X, 4, bounds="hamerly2")
    s = dataclasses.replace(s, round=torch.tensor(3, dtype=torch.int32))
    store = CheckpointStore(tmp_path)
    store.save(0, {"state": s, "b": 16})
    got = store.restore({"state": init_state(X, 4), "b": 0}, device="cpu")
    assert got["state"].elkan is None and int(got["b"]) == 16
    for f in ("C", "S", "v", "sse", "p"):
        assert torch.equal(getattr(got["state"].stats, f),
                           getattr(s.stats, f))
    assert got["state"].points.a.dtype == torch.int32
    assert int(got["state"].round) == 3


# ---------------------------------------------------------------------------
# the two packages on the same files
# ---------------------------------------------------------------------------

def _manifest(path):
    (d,) = [p for p in path.glob("step_*") if ".tmp-" not in p.name]
    leaves = json.loads((d / "manifest.json").read_text())["leaves"]
    return {k: (v["file"], v["shape"], v["dtype"], v["logical_dtype"],
                v["crc"]) for k, v in leaves.items()}


def test_bf16_leaf_crosses_both_ways(tmp_path):
    t = tree(3)
    CheckpointStore(tmp_path / "t").save(1, t)
    jt = {"w": jnp.asarray(t["w"].numpy()),
          "nested": {"b": jnp.asarray(t["nested"]["b"].float().numpy(),
                                      jnp.bfloat16),
                     "step": jnp.asarray(7, jnp.int32)}}
    JStore(tmp_path / "j").save(1, jt)
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")
    assert _manifest(tmp_path / "t")["['nested']['b']"][2:4] == \
        ("uint16", "bfloat16")
    from_j = CheckpointStore(tmp_path / "j").restore(zeros_like(t))
    assert_same(from_j, t)
    from_t = JStore(tmp_path / "t").restore(
        jax.tree.map(jnp.zeros_like, jt))
    for u, v in zip(jax.tree.leaves(from_t), jax.tree.leaves(jt)):
        assert u.dtype == v.dtype
        np.testing.assert_array_equal(np.asarray(u, np.float32),
                                      np.asarray(v, np.float32))


BOUNDS = ["hamerly2", "elkan", "exponion"]


def _cfgs(bounds, ck_dir=None):
    kw = dict(k=8, b0=512, max_rounds=5, seed=0, bounds=bounds)
    jck = japi.CheckpointConfig(checkpoint_dir=str(ck_dir), save_every=5) \
        if ck_dir else None
    tck = CheckpointConfig(checkpoint_dir=str(ck_dir), save_every=5) \
        if ck_dir else None
    return (japi.FitConfig(kernel_backend="ref", checkpoint=jck, **kw),
            FitConfig(checkpoint=tck, **kw))


def _state_arrays(state):
    out = {f"stats.{f}": getattr(state.stats, f)
           for f in ("C", "S", "v", "sse", "p")}
    out.update(a=state.points.a, d=state.points.d, lb=state.points.lb,
               round=state.round)
    if state.elkan is not None:
        out["elkan_l"] = state.elkan.l
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_states_equal(t_state, j_state):
    t, j = _state_arrays(t_state), _state_arrays(j_state)
    assert t.keys() == j.keys()
    for k in t:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("bounds", BOUNDS)
def test_fresh_capture_writes_the_jax_files(tmp_path, blobs, bounds):
    """Both engines at begin hold the same bits; their captures give the
    same manifest keys in the same order, shapes, dtypes and crcs, and
    the same engine meta."""
    X, _ = blobs
    jcfg, tcfg = _cfgs(bounds)
    jrun = JEngine().begin(X, jcfg.resolve(len(X)))
    trun = LocalEngine().begin(X, tcfg.resolve(len(X)), device="cpu")
    jtree, jmeta = jrun.capture(jrun.state)
    ttree, tmeta = trun.capture(trun.state)
    assert tmeta == jmeta
    JStore(tmp_path / "j").save(0, jtree)
    CheckpointStore(tmp_path / "t").save(0, ttree)
    jm, tm = _manifest(tmp_path / "j"), _manifest(tmp_path / "t")
    assert list(tm) == list(jm) and tm == jm
    want = ["['a']", "['d']", "['lb']", "['mb_perm']", "['round']",
            "['stats'].C", "['stats'].S", "['stats'].v", "['stats'].sse",
            "['stats'].p"]
    if bounds == "elkan":
        want.insert(2, "['elkan_l']")
    assert list(tm) == want


@pytest.mark.parametrize("bounds", BOUNDS)
def test_checkpoints_restore_across_packages(tmp_path, blobs, bounds):
    """A JAX fit's checkpoint after 5 rounds restores into the port with
    equal bits; the port's capture of that state writes the JAX files
    byte for byte (equal crcs), and JAX restores the port's files with
    equal bits."""
    X, _ = blobs
    jcfg, tcfg = _cfgs(bounds, tmp_path / "j")
    japi.fit(X, jcfg)
    jstore = JStore(tmp_path / "j")
    step, extra = jstore.latest_step(), jstore.read_extra()
    jrun = JEngine().begin(X, jcfg.resolve(len(X)))
    jstate = jrun.restore(jstore, step, extra["engine"])

    trun = LocalEngine().begin(X, tcfg.resolve(len(X)), device="cpu")
    tstep, textra = trun.resolve_resume(CheckpointStore(tmp_path / "j"))
    assert (tstep, textra) == (step, extra)
    tstate = trun.restore(CheckpointStore(tmp_path / "j"), step,
                          extra["engine"])
    _assert_states_equal(tstate, jstate)
    np.testing.assert_array_equal(trun._mb_perm, jrun._mb_perm)
    assert trun._rng.bit_generator.state == jrun._rng.bit_generator.state

    ttree, tmeta = trun.capture(tstate)
    assert tmeta == extra["engine"]
    CheckpointStore(tmp_path / "t").save(step, ttree, extra=extra)
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")

    jrun2 = JEngine().begin(X, jcfg.resolve(len(X)))
    back = jrun2.restore(JStore(tmp_path / "t"), step, extra["engine"])
    _assert_states_equal(tstate, back)

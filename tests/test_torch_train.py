"""The port's LM training path against the JAX package's, on the CPU.

`repro_torch.data.{synthetic,pipeline}` (`lm_tokens`, `LMBatches`),
`repro_torch.optim.{adamw,compression}`, `models.model.train_loss` and
its remat, `train.step.make_train_step`, `convert.opt_state_from_numpy`,
the checkpoint store's `AdamWState` keys and `launch/train.py`. JAX's
weights come from ``PRNGKey(1)`` and are carried across with
`params_from_numpy`; tokens, gradients and optimizer states from numpy
seeds.

Tolerances, stated where they are held:
  * data: bit-equal;
  * AdamW: the schedule and f32 leaves within rtol 1e-6 (`global_norm`
    adds in another order); bf16 leaves may differ by one bf16 ulp,
    where the f32 value sits by a rounding boundary;
  * compression: `encode`/`decode` and the 2-rank sum bit-equal, the
    error-feedback residual ``g - q * scale`` within one f32 ulp (eps) of
    the largest |g| (XLA may fuse the product into the subtraction);
  * loss and gradients: f32 arm (JAX's ``CDTYPE`` patched to f32 and the
    weights upcast in both) loss within 1e-5, each leaf's gradient
    within 1e-4 relative (Frobenius); bf16 arm loss within 6e-2 and each
    leaf's gradient within `BF16_GRAD_RTOL` = 5e-2 relative (measured
    at most 2.0e-2: both packages round the same activations to bf16,
    in different orders);
  * remat on and off, and kill-and-resume: bit-equal;
  * train steps (f32 arm): loss within 1e-5, params and moments within
    1e-4 relative (Frobenius) a leaf.
"""
import json
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from repro import configs as jconfigs
from repro.checkpoint.store import CheckpointStore as JStore
from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.analysis.report import repo_root
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.optim import adamw, compression
from repro_torch.train import step as tstep
from repro_torch.util.tree import tree_leaves, tree_map

CPU = "cpu"
DENSE = ["tinyllama-1.1b", "llama3.2-3b", "codeqwen1.5-7b", "qwen1.5-32b"]
BF16_GRAD_RTOL = 5e-2
OPT = dict(lr=3e-3, warmup_steps=2, decay_steps=20)
EPS = float(np.finfo(np.float32).eps)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def _batch(cfg, seed, B=4, S=16):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    labels = toks[:, 1:].astype(np.int32)
    labels[0, :3] = -100                   # masked positions
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": labels}


def _port_tree(tree):
    """A JAX tree of f32/bf16/int32 arrays as the port's (exact)."""
    def one(x):
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "int32": torch.int32}[str(x.dtype)]
        return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)
                                         if dtype != torch.int32 else x)
                                ).to(dtype)
    if isinstance(tree, jadamw.AdamWState):
        return adamw.AdamWState(*(_port_tree(t) for t in tree))
    return jax.tree.map(one, tree)


def _state_leaves(params, opt):
    """Every param and moment leaf, params first (JAX's order within)."""
    return (tree_leaves(params) + tree_leaves(opt.mu) + tree_leaves(opt.nu))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- data --------------------------------------------------------------------

def test_lm_tokens_and_batches_are_jax_bits():
    for seed, vocab in ((0, 512), (3, 32000)):
        np.testing.assert_array_equal(
            tsyn.lm_tokens(20_000, vocab=vocab, seed=seed),
            jsyn.lm_tokens(20_000, vocab=vocab, seed=seed))
    kw = dict(vocab=512, batch=4, seq=16, n_tokens=5_000, seed=1)
    got, want = tpipe.LMBatches(**kw), jpipe.LMBatches(**kw)
    assert len(got) == len(want) == 5_000 // (4 * 17)
    for step in (0, 5, len(want) + 2):      # seekable, wraps round
        a, b = got.at(step), want.at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    it = iter(got)
    np.testing.assert_array_equal(next(it)["tokens"], want.at(0)["tokens"])


# -- AdamW -------------------------------------------------------------------

def test_schedule_matches_jax_over_300_steps():
    cfg = adamw.AdamWConfig(warmup_steps=10, decay_steps=200)
    jcfg = jadamw.AdamWConfig(warmup_steps=10, decay_steps=200)
    steps = np.arange(301, dtype=np.int32)
    got = adamw.schedule(cfg, torch.from_numpy(steps))
    want = jadamw.schedule(jcfg, jnp.asarray(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def _opt_inputs(seed=0):
    """params (f32 and bf16, matrices and vectors), grads and a mid-run
    AdamW state (count 3) from a numpy seed."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (16, 24), "b": (24,), "e": (32, 8), "n": (8,)}
    bf16 = {"e", "n"}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    g = {k: (rng.normal(size=s) * 0.5).astype(np.float32)
         for k, s in shapes.items()}
    mu = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
          for k, s in shapes.items()}
    nu = {k: (rng.random(size=s) * 0.01).astype(np.float32)
          for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
          for k, v in p.items()}
    jst = jadamw.AdamWState(mu=jax.tree.map(jnp.asarray, mu),
                            nu=jax.tree.map(jnp.asarray, nu),
                            count=jnp.asarray(3, jnp.int32))
    return jp, jax.tree.map(jnp.asarray, g), jst


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_jax(clip):
    """One update from the same params, grads and state: the gradient
    clipped (clip 1) or not (100), f32 leaves within rtol 1e-6, bf16
    leaves equal but for one-ulp differences at rounding boundaries. The
    update is written into the tensors it was given (JAX donates them)."""
    jp, jg, jst = _opt_inputs()
    jcfg = jadamw.AdamWConfig(grad_clip=clip)
    want_p, want_s, want_m = jadamw.update(jp, jg, jst, jcfg)
    tp, tg, ts = _port_tree(jp), _port_tree(jg), _port_tree(jst)
    got_p, got_s, got_m = adamw.update(tp, tg, ts,
                                       adamw.AdamWConfig(grad_clip=clip))
    assert got_s.count is ts.count
    assert all(got_p[k] is tp[k] and got_s.mu[k] is ts.mu[k]
               and got_s.nu[k] is ts.nu[k] for k in jp)
    close = dict(rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), **close)
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               **close)
    assert int(got_s.count) == int(want_s.count) == 4
    for k in jp:
        np.testing.assert_allclose(got_s.mu[k].numpy(),
                                   np.asarray(want_s.mu[k]), **close)
        np.testing.assert_allclose(got_s.nu[k].numpy(),
                                   np.asarray(want_s.nu[k]), **close)
        assert got_p[k].dtype == _port_tree(jp)[k].dtype
        if got_p[k].dtype == torch.float32:
            np.testing.assert_allclose(got_p[k].numpy(),
                                       np.asarray(want_p[k]), **close)
        else:
            a = got_p[k].view(torch.int16).numpy().astype(np.int32)
            b = np.asarray(want_p[k]).view(np.int16).astype(np.int32)
            assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 0.02, k


def test_init_and_global_norm_match_jax():
    jp, jg, _ = _opt_inputs(2)
    st = adamw.init(_port_tree(jp))
    jst = jadamw.init(jp)
    assert st.count.shape == () and st.count.dtype == torch.int32
    for got, want in zip(tree_leaves(st.mu), jax.tree.leaves(jst.mu)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert not bool(got.any())
    tg = _port_tree(jg)
    np.testing.assert_allclose(float(adamw.global_norm(tg)),
                               float(jadamw.global_norm(jg)), rtol=1e-6)


# -- compression -------------------------------------------------------------

def _compress_inputs():
    rng = np.random.default_rng(5)
    g = rng.normal(size=(2, 6, 9)).astype(np.float32)
    g[1, 0, 0] = 40.0                         # one rank's larger scale
    e = (rng.normal(size=(2, 6, 9)) * 0.01).astype(np.float32)
    return g, e


def test_encode_and_decode_are_jax_bits():
    g, _ = _compress_inputs()
    for x in (g[0], g[1] * 1e-3, np.zeros((3, 4), np.float32)):
        q, s, err = compression.encode(torch.from_numpy(x))
        jq, js, jerr = jcomp.encode(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=0,
                                   atol=EPS * float(np.abs(x).max()))
        np.testing.assert_array_equal(
            compression.decode(q.to(torch.int32) * 2, s).numpy(),
            np.asarray(jcomp.decode(jq.astype(jnp.int32) * 2, js)))
    e0 = compression.init_error({"a": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert e0["a"].dtype == torch.float32 and not bool(e0["a"].any())


def test_compressed_psum_two_gloo_ranks_match_jax(tmp_path):
    """2 gloo ranks against JAX's `compressed_psum` over 2 forced host
    devices (tests/jax_audit_oracle.py in a subprocess): the decoded sums
    bit-equal on every rank, each rank's residual within one f32 ulp of
    the largest |g + e|. With no group up the sum is the identity's."""
    g, e = _compress_inputs()
    np.savez(tmp_path / "compress.npz", g=g, e=e)
    oracle = subprocess.Popen(
        [sys.executable, str(repo_root() / "tests/jax_audit_oracle.py"),
         str(tmp_path), "2"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={"PYTHONPATH": f"{repo_root() / 'src'}:{repo_root() / 'tests'}",
             "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"})
    try:
        ranks = worker.spawn(tmp_path, "compress", (2,), ("data",), g=g,
                             e=e, timeout_s=120)
        out, _ = oracle.communicate(timeout=300)
        assert oracle.returncode == 0, out
    finally:
        if oracle.poll() is None:
            oracle.kill()
    want = np.load(tmp_path / "jax_compress.npz")
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["s"], want["s"][r])
        np.testing.assert_allclose(got["err"], want["err"][r], rtol=0,
                                   atol=EPS * float(np.abs(g + e).max()))
    one, _ = compression.compressed_psum({"g": torch.from_numpy(g[0])},
                                         {"g": torch.from_numpy(e[0])})
    q, s, _ = compression.encode(torch.from_numpy(g[0] + e[0]))
    assert torch.equal(one["g"], compression.decode(q.to(torch.int32), s))


# -- the loss and its gradients ----------------------------------------------

@pytest.fixture(scope="module")
def jax_models():
    """{arch: (reduced config, JAX params from PRNGKey(1))}."""
    return {a: (jconfigs.get_reduced(a),
                JM.init_params(jax.random.PRNGKey(1),
                               jconfigs.get_reduced(a)))
            for a in DENSE}


def _port_grads(params, batch, cfg, remat=True):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = TM.train_loss(live, _t(batch), cfg, remat=remat)
    return loss, aux, torch.autograd.grad(loss, tree_leaves(live))


@pytest.mark.parametrize("arch,arm", [("tinyllama-1.1b", "bf16")]
                         + [(a, "f32") for a in DENSE])
def test_train_loss_and_grads_match_jax(jax_models, arch, arm, monkeypatch):
    """The same weights and batch (labels -100 masked) through both
    packages' `train_loss` and its gradient, leaf by leaf: every dense
    architecture in the f32 arm, tinyllama-1.1b in bf16 too."""
    jcfg, jp = jax_models[arch]
    cfg = configs.get_reduced(arch)
    if arm == "f32":
        monkeypatch.setattr(JL, "CDTYPE", jnp.float32)
        jp = _f32(jp)
    batch = _batch(cfg, 0)
    (jloss, jaux), jg = jax.value_and_grad(
        lambda p: JM.train_loss(p, _j(batch), jcfg), has_aux=True)(jp)
    loss, aux, grads = _port_grads(
        params_from_numpy(jax.tree.map(np.asarray, jp), CPU), batch, cfg)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    loss = loss.detach()
    assert float(aux["xent"].detach()) == float(loss)
    tol, grad_rtol = (1e-5, 1e-4) if arm == "f32" else (6e-2, BF16_GRAD_RTOL)
    assert abs(float(loss) - float(jloss)) <= tol
    names = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, got, want in zip(names, grads, jax.tree.leaves(jg)):
        assert got.dtype == (torch.float32 if arm == "f32"
                             else torch.bfloat16), name
        assert _rel(got, want) <= grad_rtol, (name, _rel(got, want))


def test_remat_gives_the_same_bits(jax_models):
    """Recomputing each period in the backward pass changes no value."""
    cfg = configs.get_reduced("tinyllama-1.1b")
    params = params_from_numpy(
        jax.tree.map(np.asarray, jax_models["tinyllama-1.1b"][1]), CPU)
    batch = _batch(cfg, 1)
    l1, _, g1 = _port_grads(params, batch, cfg, remat=True)
    l0, _, g0 = _port_grads(params, batch, cfg, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


# -- train steps -------------------------------------------------------------

def _leaves_close(got, want, rtol, what):
    names = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    for name, a, b in zip(names, tree_leaves(got), jax.tree.leaves(want)):
        assert _rel(a, b) <= rtol, (what, name, _rel(a, b))


@pytest.fixture(scope="module")
def jax_run(jax_models):
    """JAX's tinyllama-1.1b --reduced in the f32 arm: its jitted train
    step (n_micro 2, compiled once), the start state and the states and
    losses of 3 steps on `LMBatches` from seed 0."""
    orig = JL.CDTYPE
    JL.CDTYPE = jnp.float32
    try:
        jcfg, jp = jax_models["tinyllama-1.1b"]
        step = jax.jit(jstep.make_train_step(
            jcfg, n_micro=2, opt_cfg=jadamw.AdamWConfig(**OPT)))
        data = jpipe.LMBatches(vocab=jcfg.vocab, batch=4, seq=16,
                               n_tokens=20_000, seed=0)
        params, opt = _f32(jp), jadamw.init(_f32(jp))
        states, losses = [(params, opt)], []
        for s in range(3):
            params, opt, m = step(params, opt, _j(data.at(s)))
            states.append((params, opt))
            losses.append(float(m["loss"]))
        jax.block_until_ready(states)
    finally:
        JL.CDTYPE = orig
    return {"step": step, "states": states, "losses": losses,
            "data": data}


def _port_state(state):
    host = jax.tree.map(np.asarray, state)
    return params_from_numpy(host[0], CPU), opt_state_from_numpy(host[1], CPU)


def test_three_steps_track_jax(jax_run):
    """3 steps of n_micro 2 from JAX's start state: each loss within
    1e-5, params and moments within 1e-4 relative a leaf, count 3."""
    cfg = configs.get_reduced("tinyllama-1.1b")
    step = tstep.make_train_step(cfg, n_micro=2,
                                 opt_cfg=adamw.AdamWConfig(**OPT))
    params, opt = _port_state(jax_run["states"][0])
    for s in range(3):
        params, opt, m = step(params, opt, _t(jax_run["data"].at(s)))
        assert abs(float(m["loss"]) - jax_run["losses"][s]) <= 1e-5
    jparams, jopt = jax_run["states"][3]
    _leaves_close(params, jparams, 1e-4, "params")
    _leaves_close(opt.mu, jopt.mu, 1e-4, "mu")
    _leaves_close(opt.nu, jopt.nu, 1e-4, "nu")
    assert int(opt.count) == int(jopt.count) == 3


def test_n_micro_2_equals_n_micro_1(jax_run):
    """The same batch in one or two microbatches: the same step within
    f32 tolerance (the loss within 1e-5, params and moments within 1e-5
    relative a leaf); the step's metrics stay on the device."""
    cfg = configs.get_reduced("tinyllama-1.1b")
    batch = _t(jax_run["data"].at(0))
    out = {}
    for n_micro in (1, 2):
        params, opt = _port_state(jax_run["states"][0])
        step = tstep.make_train_step(cfg, n_micro=n_micro,
                                     opt_cfg=adamw.AdamWConfig(**OPT))
        out[n_micro] = step(params, opt, batch)
    (p1, o1, m1), (p2, o2, m2) = out[1], out[2]
    assert all(isinstance(v, torch.Tensor) and v.shape == ()
               for v in m2.values()) and set(m2) == {"loss", "lr",
                                                     "grad_norm"}
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5
    for a, b in zip(_state_leaves(p1, o1), _state_leaves(p2, o2)):
        assert _rel(a, b) <= 1e-5


def test_checkpoints_resume_across_packages(jax_run, tmp_path):
    """JAX's checkpoint of step 1 resumes in the port (step 2); the
    port's checkpoint of step 2 resumes in JAX (step 3), which tracks
    JAX's unbroken step 3 as `test_three_steps_track_jax` does. Both
    stores write the same keys and each restores the other's bits."""
    cfg = configs.get_reduced("tinyllama-1.1b")
    step = tstep.make_train_step(cfg, n_micro=2,
                                 opt_cfg=adamw.AdamWConfig(**OPT))
    jp1, jo1 = jax_run["states"][1]
    JStore(tmp_path / "jax").save(1, {"params": jp1, "opt": jo1})
    tp, to = _port_state(jax_run["states"][0])
    got = CheckpointStore(tmp_path / "jax").restore(
        {"params": tp, "opt": to})
    assert isinstance(got["opt"], adamw.AdamWState)
    for a, b in zip(_state_leaves(got["params"], got["opt"]),
                    jax.tree.leaves((jp1, jo1.mu, jo1.nu))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got["opt"].count) == 1
    p2, o2, _ = step(got["params"], got["opt"], _t(jax_run["data"].at(1)))
    CheckpointStore(tmp_path / "port").save(2, {"params": p2, "opt": o2})
    manifests = [sorted(json.loads(
        next((tmp_path / d).glob("step_*/manifest.json")).read_text())
        ["leaves"]) for d in ("jax", "port")]
    assert manifests[0] == manifests[1]
    assert "['opt'].count" in manifests[0]
    jrest = JStore(tmp_path / "port").restore({"params": jp1, "opt": jo1})
    for a, b in zip(_state_leaves(p2, o2),
                    jax.tree.leaves((jrest["params"], jrest["opt"].mu,
                                     jrest["opt"].nu))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    JL_orig, JL.CDTYPE = JL.CDTYPE, jnp.float32
    try:
        jp3, jo3, _ = jax_run["step"](jrest["params"], jrest["opt"],
                                      _j(jax_run["data"].at(2)))
    finally:
        JL.CDTYPE = JL_orig
    want_p, want_o = jax_run["states"][3]
    assert int(jo3.count) == 3
    for a, b in zip(jax.tree.leaves((jp3, jo3.mu, jo3.nu)),
                    jax.tree.leaves((want_p, want_o.mu, want_o.nu))):
        assert _rel(a, b) <= 1e-4


def test_killed_run_resumes_bit_equal(tmp_path):
    """tinyllama-1.1b --reduced in bf16 for 6 steps, against 3 steps, a
    background checkpoint labelled 3 (the steps it holds, as the CLI
    labels it), a fresh process's state restored from it and 3 more
    steps: every param and moment the same bits."""
    cfg = configs.get_reduced("tinyllama-1.1b")
    step = tstep.make_train_step(cfg, n_micro=2)
    data = tpipe.LMBatches(vocab=cfg.vocab, batch=4, seq=16,
                           n_tokens=20_000, seed=0)

    def run(params, opt, steps, store=None):
        for s in steps:
            params, opt, _ = step(params, opt, _t(data.at(s)))
            if store is not None and s == 2:
                store.save(3, {"params": params, "opt": opt},
                           background=True)
        return params, opt

    p = TM.init_params(0, cfg, CPU)
    unbroken = run(p, adamw.init(p), range(6))
    store = CheckpointStore(tmp_path / "ck")
    p = TM.init_params(0, cfg, CPU)
    run(p, adamw.init(p), range(4), store)    # killed in step 3
    store.wait()
    template = TM.init_params(7, cfg, CPU)
    got = store.restore({"params": template, "opt": adamw.init(template)})
    resumed = run(got["params"], got["opt"], range(3, 6))
    for a, b in zip(_state_leaves(*unbroken), _state_leaves(*resumed)):
        assert torch.equal(a, b)
    assert int(resumed[1].count) == int(unbroken[1].count) == 6


# -- the CLI -----------------------------------------------------------------

def _train_cli(ck, *args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "tinyllama-1.1b", "--reduced", "--device", "cpu", "--ckpt-dir",
         str(ck), *args],
        capture_output=True, text=True, cwd=repo_root(), timeout=300,
        env={"PYTHONPATH": str(repo_root() / "src"),
             "PATH": "/usr/bin:/bin:/usr/local/bin"})


def test_train_cli_prints_jax_lines_and_codebook(tmp_path):
    """``python -m repro_torch.launch.train --arch tinyllama-1.1b
    --reduced --steps 4 --ckpt-every 2 --device cpu --codebook 8`` with
    JAX's defaults (batch 8, seq 128, n_micro 2): rc 0 and JAX's line
    formats. Its mid-run checkpoint holds the 2 steps it is labelled
    with; the run killed after that save (its final checkpoint lost) and
    started again resumes at step 2 and ends on the unbroken run's bits
    and step line."""
    ck = tmp_path / "ck"
    r = _train_cli(ck, "--steps", "4", "--ckpt-every", "2", "--codebook",
                   "8")
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    n = configs.get_reduced("tinyllama-1.1b")
    assert lines[0] == (f"tinyllama-1.1b (reduced): "
                        f"{n.param_count() + n.d_model:,} params")
    step_re = (r"step +(\d+) loss (\d+\.\d{4}) lr (\d\.\d\de[-+]\d\d) "
               r"gnorm (\d+\.\d{3}) \((\d+\.\d)s\)")
    steps = [re.fullmatch(step_re, ln) for ln in lines[1:3]]
    assert [int(m[1]) for m in steps] == [0, 3], r.stdout
    assert lines[3] == "final checkpoint at step 4"
    assert re.fullmatch(r"embedding codebook \(k=8\): VQ-MSE \d+\.\d{6} "
                        r"occupancy min=\d+ max=\d+ empty=\d+", lines[4])
    store = CheckpointStore(ck)
    assert store.steps() == [2, 4]

    def state(step):
        t = TM.init_params(7, n, CPU)
        got = store.restore({"params": t, "opt": adamw.init(t)}, step=step)
        return got["params"], got["opt"]

    assert int(state(2)[1].count) == 2
    unbroken = state(4)
    assert int(unbroken[1].count) == 4
    for d in ck.glob("step_000000004*"):      # killed before the final save
        shutil.rmtree(d)
    r = _train_cli(ck, "--steps", "4")
    assert r.returncode == 0, r.stdout + r.stderr
    again = r.stdout.splitlines()
    assert again[1] == "resumed from checkpoint at step 2", r.stdout
    assert (re.fullmatch(step_re, again[2]).groups()[:4]
            == steps[1].groups()[:4]), r.stdout
    resumed = state(4)
    for a, b in zip(_state_leaves(*unbroken), _state_leaves(*resumed)):
        assert torch.equal(a, b)
    assert int(resumed[1].count) == 4


def _jax_cli_batches(monkeypatch, capsys, argv):
    """JAX's train CLI run in this process with ``argv``, its step
    replaced by one that records the batch it is given (as numpy) and
    returns zero metrics: (its stdout lines, the batches)."""
    from repro.launch import train as jlaunch
    seen = []

    def make_train_step(cfg, **kw):
        def step(params, opt, batch):
            jax.debug.callback(
                lambda b: seen.append(jax.tree.map(np.asarray, b)), batch)
            zero = jnp.zeros((), jnp.float32)
            return params, opt, {"loss": zero, "lr": zero,
                                 "grad_norm": zero}
        return step

    monkeypatch.setattr(jlaunch.tstep, "make_train_step", make_train_step)
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    jlaunch.main()
    return capsys.readouterr().out.splitlines(), seen


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-76b"])
def test_train_cli_runs_encdec_and_vlm_with_jax_stubs(arch, monkeypatch,
                                                       capsys):
    """``python -m repro_torch.launch.train --arch ARCH --reduced --steps
    2 --device cpu`` in this process, with JAX's defaults (batch 8, seq
    128, n_micro 2): JAX's lines (its note on the modality stubs, the
    parameter count, the step lines' format), and each step's batch is
    the one JAX's CLI makes: zero bf16 frames (whisper) or patches
    (internvl2), and the vlm's tokens and labels without their first
    n_ctx = 8 columns, since seq 128 > 8 (JAX's ``to_batch``)."""
    argv = ["--arch", arch, "--reduced", "--steps", "2"]
    jlines, jbatches = _jax_cli_batches(monkeypatch, capsys, argv)
    seen = []
    real = tstep.make_train_step

    def recording(cfg, **kw):
        step = real(cfg, **kw)

        def run(params, opt, batch):
            seen.append({k: v.clone() for k, v in batch.items()})
            return step(params, opt, batch)
        return run

    monkeypatch.setattr(tlaunch.tstep, "make_train_step", recording)
    tlaunch.main([*argv, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    cfg = configs.get_reduced(arch)
    assert lines[:2] == jlines[:2], (lines, jlines)
    assert lines[0].startswith(f"note: {arch} needs modality inputs")
    step_re = (r"step +(\d+) loss (\d+\.\d{4}) lr (\d\.\d\de[-+]\d\d) "
               r"gnorm (\d+\.\d{3}) \((\d+\.\d)s\)")
    for got, want in zip(lines[2:], jlines[2:]):
        assert re.fullmatch(step_re, got) and re.fullmatch(step_re, want)
    assert len(lines) == len(jlines) == 4
    assert float(re.fullmatch(step_re, lines[2])[2]) > 0
    seq = 128 - (cfg.encoder.n_ctx if cfg.family == "vlm" else 0)
    assert len(seen) == len(jbatches) == 2
    for got, want in zip(seen, jbatches):
        assert sorted(got) == sorted(want)
        assert tuple(got["tokens"].shape) == (8, seq)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), want[k])
        stub = "frames" if cfg.family == "encdec" else "patches"
        assert got[stub].dtype == torch.bfloat16
        assert str(want[stub].dtype) == "bfloat16"
        assert tuple(got[stub].shape) == want[stub].shape
        assert not bool(got[stub].any()) and not want[stub].any()

"""The port's Mamba2 SSD and hybrid families against the JAX package's, on
the CPU.

`repro_torch.models.layers.{_causal_conv,mamba_fwd,mamba_decode_fwd}`,
`models.model` for ``family="ssm"`` (mamba2) and ``"hybrid"`` (jamba:
an attention position and a Mamba position with MoE a period, reduced),
its caches, `train_loss` and its gradients, and the SSD's gradient where
the reference's overflows (ROADMAP Queue 3 item 9). JAX's weights come
from ``PRNGKey(1)`` and are carried across with `params_from_numpy`;
tokens and activations from numpy seeds. ``A_log`` and ``dt_bias`` are
redrawn from numpy in the layer tests (their init is 0), so the decays
differ by head.

Tolerances, stated where they are held:
  * `_causal_conv`: bit-equal in bf16 (the products added left to right
    in bf16, then silu in f32 rounded once);
  * `mamba_fwd`, `mamba_decode_fwd`: bf16 arm 6e-2, f32 arm (JAX's
    ``CDTYPE`` patched, the weights upcast) 1e-5; the f32 SSM state
    1e-5; the conv states at the arm's tolerance;
  * prefill and decode logits and caches: 6e-2 (bf16 activations),
    against JAX's steps compiled with ``xla_allow_excess_precision``
    off: by default XLA may skip a bf16 rounding inside a fusion (it
    does in the Mamba decode step), and in jamba one such ulp moved the
    decode's logits by 0.33 at seed 2, while the port, and JAX's layers
    op by op, round where the model says;
  * `train_loss` and its gradients (f32 arm): the loss within 1e-5, each
    leaf's gradient within 1e-4 relative (Frobenius).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint.store import CheckpointStore as JStore
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.util.tree import tree_leaves, tree_map

CPU = "cpu"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=6e-2, atol=6e-2)
ARCHS = ["mamba2-2.7b", "jamba-v0.1-52b"]


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _t(x) -> torch.Tensor:
    """A JAX f32 or bf16 array as a tensor of its dtype (exact)."""
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def _port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _batch(cfg, seed, B=2, S=16):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    labels = toks[:, 1:].astype(np.int32)
    labels[0, :3] = -100                   # masked positions
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": labels}


def _exact_jit(fn, *args):
    """JAX's jitted ``fn(*args)`` with every bf16 rounding the code
    writes (``xla_allow_excess_precision`` off)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_models():
    """{arch: (reduced config, JAX params from PRNGKey(1))}."""
    return {a: (jconfigs.get_reduced(a),
                JM.init_params(jax.random.PRNGKey(1),
                               jconfigs.get_reduced(a)))
            for a in ARCHS}


@pytest.fixture(params=["bf16", "f32"])
def mamba(request, jax_models, monkeypatch):
    """(JAX mamba params of mamba2 reduced's first layer, A_log and
    dt_bias redrawn; the port's; cfg; the activations' JAX dtype), in
    the bf16 arm or the f32 one (JAX's ``CDTYPE`` patched, the weights
    upcast)."""
    jcfg, jp = jax_models["mamba2-2.7b"]
    mp = dict(jax.tree.map(lambda w: w[0], jp["blocks"]["0"]["mamba"]))
    rng = np.random.default_rng(7)
    nh = mp["A_log"].shape[0]
    mp["A_log"] = jnp.asarray(rng.uniform(-1.0, 1.0, nh), jnp.float32)
    mp["dt_bias"] = jnp.asarray(rng.normal(size=nh), jnp.float32)
    dtype = jnp.bfloat16
    if request.param == "f32":
        monkeypatch.setattr(JL, "CDTYPE", jnp.float32)
        mp, dtype = _f32(mp), jnp.float32
    return mp, {k: _t(v) for k, v in mp.items()}, jcfg, dtype


# -- layers ------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_is_jax_bits(with_state):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 32, 48)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(4, 48)) * 0.3, jnp.bfloat16)
    s = (jnp.asarray(rng.normal(size=(2, 3, 48)), jnp.bfloat16)
         if with_state else None)
    jy, js = JL._causal_conv(x, w, s)
    ty, ts = TL._causal_conv(_t(x), _t(w), None if s is None else _t(s))
    assert ty.dtype == ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("L", [48, 40, 7])
def test_mamba_fwd_matches_jax(mamba, L):
    """L = 48 runs 3 chunks of 16 with the state carried; L = 40 front-
    pads 8 rows to 3 chunks; L = 7 runs one chunk of 7. The output, and
    with ``return_state`` the f32 SSM state and the conv states."""
    mp, tp, cfg, dtype = mamba
    u = jnp.asarray(np.random.default_rng(L).normal(
        size=(2, L, cfg.d_model)), dtype)
    want, jst = _exact_jit(functools.partial(
        JL.mamba_fwd, ssm=cfg.ssm, d=cfg.d_model, return_state=True), mp, u)
    got, st = TL.mamba_fwd(tp, _t(u), cfg.ssm, cfg.d_model,
                           return_state=True)
    tol = BF16 if dtype == jnp.bfloat16 else F32
    assert got.shape == (2, L, cfg.d_model) and got.dtype == _t(u).dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert st["ssm"].dtype == torch.float32
    np.testing.assert_allclose(_np(st["ssm"]), _np(jst["ssm"]), **F32)
    for part in ("x", "bc"):
        np.testing.assert_allclose(_np(st["conv"][part]),
                                   _np(jst["conv"][part]), **tol)
    alone = TL.mamba_fwd(tp, _t(u), cfg.ssm, cfg.d_model)
    assert torch.equal(alone, got)


def test_mamba_decode_matches_jax(mamba):
    """One token from the state a 32-token prompt left, in both packages
    from the same (JAX's) state."""
    mp, tp, cfg, dtype = mamba
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.normal(size=(2, 32, cfg.d_model)), dtype)
    u1 = jnp.asarray(rng.normal(size=(2, 1, cfg.d_model)), dtype)
    _, jst = _exact_jit(functools.partial(
        JL.mamba_fwd, ssm=cfg.ssm, d=cfg.d_model, return_state=True), mp, u)
    want, jnew = JL.mamba_decode_fwd(mp, u1, cfg.ssm, cfg.d_model, jst)
    state = {"ssm": _t(jst["ssm"]),
             "conv": {k: _t(v) for k, v in jst["conv"].items()}}
    got, new = TL.mamba_decode_fwd(tp, _t(u1), cfg.ssm, cfg.d_model, state)
    tol = BF16 if dtype == jnp.bfloat16 else F32
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(new["ssm"]), _np(jnew["ssm"]), **F32)
    for part in ("x", "bc"):
        np.testing.assert_allclose(_np(new["conv"][part]),
                                   _np(jnew["conv"][part]), **tol)


# -- the models --------------------------------------------------------------

def test_ssm_param_tree_matches_jax():
    cfg = configs.get_reduced("mamba2-2.7b")
    got = TM.init_params(0, cfg, CPU)
    want = jax.eval_shape(lambda: JM.init_params(
        jax.random.PRNGKey(0), jconfigs.get_reduced("mamba2-2.7b")))
    shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), want)
    assert set(got["blocks"]["0"]) == {"ln1", "mamba"}
    for k, v in got["blocks"]["0"]["mamba"].items():
        assert (tuple(v.shape), str(v.dtype).replace("torch.", "")) == \
            shapes["blocks"]["0"]["mamba"][k], k


def test_jamba_checkpoint_has_jax_keys(jax_models, tmp_path):
    """A ``{"params", "opt"}`` checkpoint of the reduced jamba (attention
    and Mamba positions, MoE on the odd one; the router's and the SSD's
    f32 leaves beside bf16 ones): both stores write the same keys,
    shapes and dtypes, and the port restores JAX's file bit for bit."""
    _, jp = jax_models["jamba-v0.1-52b"]
    jopt = jadamw.init(jp)
    JStore(tmp_path / "jax").save(1, {"params": jp, "opt": jopt})
    host = jax.tree.map(np.asarray, (jp, jopt))
    tp = params_from_numpy(host[0], CPU)
    CheckpointStore(tmp_path / "port").save(1, {"params": tp,
                                                "opt": adamw.init(tp)})
    manifests = [json.loads(next((tmp_path / d).glob(
        "step_*/manifest.json")).read_text())["leaves"]
        for d in ("jax", "port")]
    assert sorted(manifests[0]) == sorted(manifests[1])
    assert "['params']['blocks']['1']['mamba']['A_log']" in manifests[0]
    assert "['opt'].mu['blocks']['1']['moe']['router']" in manifests[0]
    for k, v in manifests[0].items():
        assert {f: v[f] for f in v if f != "file"} == \
            {f: manifests[1][k][f] for f in manifests[1][k] if f != "file"}, k
    like = {"params": TM.init_params(3, configs.get_reduced(
        "jamba-v0.1-52b"), CPU)}
    like["opt"] = adamw.init(like["params"])
    got = CheckpointStore(tmp_path / "jax").restore(like)
    want = opt_state_from_numpy(host[1], CPU)
    for a, b in zip(tree_leaves(got["params"]) + tree_leaves(got["opt"].mu),
                    tree_leaves(tp) + tree_leaves(want.mu)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(jax_models, arch):
    """The same weights and tokens: prefill's logits and its cache (K/V
    rows in attention positions, SSM and conv states in Mamba ones), then
    one decode step's logits and cache, through both step makers."""
    jcfg, jp = jax_models[arch]
    cfg = configs.get_reduced(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 21))
    cache_len = 24
    jl, jc = _exact_jit(jstep.make_prefill_step(jcfg, cache_len=cache_len),
                        jp, {"tokens": jnp.asarray(toks[:, :-1])})
    jd, jc2 = _exact_jit(jstep.make_decode_step(jcfg), jp,
                         jnp.asarray(toks[:, -1:], jnp.int32), jc)
    tp = _port(jp)
    tl, tc = tstep.make_prefill_step(cfg, cache_len=cache_len)(
        tp, {"tokens": torch.from_numpy(toks[:, :-1])})
    np.testing.assert_allclose(_np(tl), _np(jl), **BF16)
    assert int(tc["pos"]) == int(jc["pos"]) == 20
    want_leaves = jax.tree_util.tree_flatten_with_path(jc["blocks"])[0]
    assert len(tree_leaves(tc["blocks"])) == len(want_leaves)
    for got, (path, want) in zip(tree_leaves(tc["blocks"]), want_leaves):
        name = jax.tree_util.keystr(path)
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
        np.testing.assert_allclose(_np(got), _np(want), **BF16)
    td, tc2 = tstep.make_decode_step(cfg)(
        tp, torch.from_numpy(toks[:, -1:]).to(torch.int32), tc)
    np.testing.assert_allclose(_np(td), _np(jd), **BF16)
    assert int(tc2["pos"]) == 21
    for got, want in zip(tree_leaves(tc2["blocks"]),
                         jax.tree.leaves(jc2["blocks"])):
        np.testing.assert_allclose(_np(got), _np(want), **BF16)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """Prefill S tokens then decode token S == prefill of S + 1 tokens,
    with the port's own weights (jamba's MoE at capacity factor 8); the
    decode writes its SSM and conv states into the cache's tensors."""
    cfg = configs.get_reduced(arch)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = TM.init_params(1, cfg, CPU)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 21)))
    prefill = tstep.make_prefill_step(cfg, cache_len=24)
    _, cache = prefill(params, {"tokens": toks[:, :-1]})
    t = next(t for t in cache["blocks"] if "ssm" in cache["blocks"][t])
    ssm, conv = cache["blocks"][t]["ssm"], cache["blocks"][t]["conv"]["x"]
    before = ssm.clone()
    logits_d, new = tstep.make_decode_step(cfg)(params, toks[:, -1:], cache)
    logits_f, full = prefill(params, {"tokens": toks})
    np.testing.assert_allclose(_np(logits_d[:, 0]), _np(logits_f[:, -1]),
                               **BF16)
    # donated: the same storage now holds the state after token 20
    assert new["blocks"][t]["ssm"] is ssm and not torch.equal(ssm, before)
    assert new["blocks"][t]["conv"]["x"] is conv
    np.testing.assert_allclose(_np(ssm), _np(full["blocks"][t]["ssm"]),
                               **BF16)
    np.testing.assert_allclose(_np(conv),
                               _np(full["blocks"][t]["conv"]["x"]), **BF16)


def _port_grads(params, batch, cfg, remat=True):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = TM.train_loss(live, _tbatch(batch), cfg, remat=remat)
    return loss.detach(), aux, torch.autograd.grad(loss, tree_leaves(live))


def _jax_grads(jp, batch, jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p: JM.train_loss(p, _jbatch(batch), jcfg), has_aux=True))(jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(jax_models, arch, monkeypatch):
    """The f32 arm (JAX's ``CDTYPE`` patched, the weights upcast): the
    loss, jamba's aux, and each leaf's gradient; remat on and off give
    the same bits."""
    jcfg, jp = jax_models[arch]
    cfg = configs.get_reduced(arch)
    monkeypatch.setattr(JL, "CDTYPE", jnp.float32)
    jp = _f32(jp)
    batch = _batch(cfg, 0)
    (jloss, jaux), jg = _jax_grads(jp, batch, jcfg)
    params = _port(jp)
    loss, aux, grads = _port_grads(params, batch, cfg)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    aux = float(aux["aux"].detach())
    assert abs(aux - float(jaux["aux"])) <= 1e-5 * max(float(jaux["aux"]), 1)
    assert (aux > 0) == (cfg.moe is not None)
    names = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, got, want in zip(names, grads, jax.tree.leaves(jg)):
        assert got.dtype == torch.float32, name
        assert _rel(got, want) <= 1e-4, (name, _rel(got, want))
    l0, _, g0 = _port_grads(params, batch, cfg, remat=False)
    assert torch.equal(loss, l0)
    assert all(torch.equal(a, b) for a, b in zip(grads, g0))


def test_ssd_gradient_is_finite_where_the_reference_overflows(
        jax_models, monkeypatch):
    """ROADMAP Queue 3 item 9. mamba2 reduced with ``chunk=128`` at
    S = 128 runs one chunk of Q = 128: JAX's decay matrix takes
    ``exp(seg_q - seg_s)`` over the whole square before its causal
    ``where``, the exponent above the diagonal passes f32's range, and
    its gradient is NaN in most leaves though the loss is finite. The
    port masks before the exponential: its loss is JAX's (within 1e-5)
    and every gradient is finite and within 1e-4 of JAX's at
    ``chunk=16`` on the same batch (the same function chunked
    otherwise). f32 arm."""
    jbase, jp = jax_models["mamba2-2.7b"]
    monkeypatch.setattr(JL, "CDTYPE", jnp.float32)
    jp = _f32(jp)
    batch = _batch(jbase, 4, S=128)

    def chunked(cfg, chunk):
        return dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=chunk))

    (jl128, _), jg128 = _jax_grads(jp, batch, chunked(jbase, 128))
    (jl16, _), jg16 = _jax_grads(jp, batch, chunked(jbase, 16))
    bad = [bool(~jnp.isfinite(g).all()) for g in jax.tree.leaves(jg128)]
    assert np.isfinite(float(jl128)) and sum(bad) >= len(bad) // 2, bad
    cfg = chunked(configs.get_reduced("mamba2-2.7b"), 128)
    loss, _, grads = _port_grads(_port(jp), batch, cfg)
    assert abs(float(loss) - float(jl128)) <= 1e-5
    assert abs(float(jl16) - float(jl128)) <= 1e-5
    for got, want in zip(grads, jax.tree.leaves(jg16)):
        assert bool(torch.isfinite(got).all())
        assert _rel(got, want) <= 1e-4, _rel(got, want)

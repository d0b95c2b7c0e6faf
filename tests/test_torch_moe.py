"""The port's MoE family against the JAX package's, on the CPU.

`repro_torch.models.layers.{init_moe,moe_fwd}`, the period structure of
`models.model` for ``family="moe"`` (granite's "all" layout) and the
hybrid's tree (jamba's "alternate" MoE positions),
`convert.params_from_numpy`, `train_loss`'s aux term, the train step and
both CLIs. JAX's weights come from ``PRNGKey(1)`` and are carried
across with `params_from_numpy`; tokens and activations from numpy
seeds.

Tolerances, stated where they are held:
  * `moe_fwd`: bf16 arm 6e-2, f32 arm (JAX's ``CDTYPE`` patched, the
    weights upcast) 1e-5; the aux loss within 1e-6 relative in both (a
    mean over the tokens, added in another order);
  * prefill and decode logits and caches: 6e-2 (bf16 activations);
    decode against the prefill one token longer at capacity factor 8
    (drops depend on the token count, as tests/test_models.py holds it);
  * `train_loss` and its gradients (f32 arm): the loss within 1e-5, each
    leaf's gradient within 1e-4 relative (Frobenius); 3 train steps:
    each loss within 1e-5, params and moments within 1e-4 a leaf.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.util.tree import tree_leaves, tree_map

CPU = "cpu"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=6e-2, atol=6e-2)
MOE = ["granite-moe-1b-a400m", "qwen3-moe-235b-a22b"]
OPT = dict(lr=3e-3, warmup_steps=2, decay_steps=20)


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32), np.float64)


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _f32(tree):
    return jax.tree.map(lambda x: x.astype(jnp.float32), tree)


def _t(x) -> torch.Tensor:
    """A JAX f32 or bf16 array as a tensor of its dtype (exact)."""
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(
        torch.bfloat16 if x.dtype == jnp.bfloat16 else torch.float32)


def _port(tree):
    """A numpy-leaved copy of a JAX tree as the port's (bit for bit)."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _with_cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _batch(cfg, seed, B=2, S=16):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1))
    labels = toks[:, 1:].astype(np.int32)
    labels[0, :3] = -100                   # masked positions
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": labels}


@pytest.fixture(scope="module")
def jax_models():
    """{arch: (reduced config, JAX params from PRNGKey(1))}."""
    return {a: (jconfigs.get_reduced(a),
                JM.init_params(jax.random.PRNGKey(1),
                               jconfigs.get_reduced(a)))
            for a in MOE}


# -- moe_fwd -----------------------------------------------------------------

@pytest.mark.parametrize("arm", ["bf16", "f32"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", MOE)
def test_moe_fwd_matches_jax(jax_models, arch, cf, arm, monkeypatch):
    """One layer's MoE on the same weights and activations: top-4 of 8
    (granite reduced) and top-2 of 8 (qwen3 reduced), at the configs'
    capacity factor and at 0.5, where many (token, choice) pairs are
    dropped."""
    jcfg, jp = jax_models[arch]
    moe = jax.tree.map(lambda w: w[1], jp["blocks"]["0"]["moe"])
    mc = dataclasses.replace(jcfg.moe, capacity_factor=cf)
    x = jnp.asarray(np.random.default_rng(3).normal(
        size=(2, 16, jcfg.d_model)), jnp.bfloat16)
    if arm == "f32":
        monkeypatch.setattr(JL, "CDTYPE", jnp.float32)
        moe, x = _f32(moe), x.astype(jnp.float32)
    want, jaux = JL.moe_fwd(moe, x, mc)
    tp = {k: _t(v) for k, v in moe.items()}
    assert tp["router"].dtype == torch.float32
    got, aux = TL.moe_fwd(tp, _t(x), mc)
    assert got.dtype == tp["w_up"].dtype and aux.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if arm == "f32" else BF16))
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # at cf 0.5 the experts hold fewer slots than there are (token,
    # choice) pairs: at least T * K - E * cap of them are dropped
    T, E, K = 32, mc.n_experts, mc.top_k
    _, _, _, valid, slot, cap = TL.moe_route(tp, _t(x).reshape(T, -1), mc)
    assert cap == int(cf * T * K / E + 0.999)
    assert int((~valid).sum()) >= T * K - E * cap
    assert (E * cap < T * K) == (cf < 1)
    kept = slot[valid]
    assert len(set(kept.tolist())) == len(kept) and bool((kept < E * cap)
                                                          .all())


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE + ["jamba-v0.1-52b"])
def test_param_tree_matches_jax_and_converts_bit_for_bit(arch):
    """`init_params` builds JAX's tree (keys, shapes stacked over periods
    and keyed by period position, dtypes: the router f32, the SSD's
    decay leaves f32); `params_from_numpy` of JAX's weights keeps every
    bit and dtype."""
    cfg = configs.get_reduced(arch)
    got = TM.init_params(0, cfg, CPU)
    jcfg = jconfigs.get_reduced(arch)
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    assert _tree_shapes(got) == _tree_shapes(want)
    assert set(got["blocks"]) == {str(t) for t in range(TM.period_len(cfg))}
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    host = jax.tree.map(np.asarray, jp)
    carried = params_from_numpy(host, CPU)
    for x, y in zip(tree_leaves(carried), jax.tree.leaves(host)):
        assert str(x.dtype).replace("torch.", "") == str(y.dtype)
        if x.dtype == torch.bfloat16:
            np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                          y.view(np.int16))
        else:
            np.testing.assert_array_equal(x.numpy(), y)


def test_period_structure_matches_jax():
    for arch in jconfigs.list_archs():
        jcfg = jconfigs.get_config(arch)
        cfg = configs.get_config(arch)
        assert TM.period_len(cfg) == JM.period_len(jcfg)
        assert TM.n_periods(cfg) == JM.n_periods(jcfg)
        for t in range(TM.period_len(cfg)):
            for f in ("pos_is_attn", "pos_is_moe", "pos_has_ffn"):
                assert getattr(TM, f)(cfg, t) == getattr(JM, f)(jcfg, t)
    jamba = configs.get_config("jamba-v0.1-52b")
    assert [TM.pos_is_moe(jamba, t) for t in range(8)] == [False, True] * 4
    assert [TM.pos_is_attn(jamba, t) for t in range(8)] == \
        [True] + [False] * 7


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(jax_models, arch):
    """The same weights and tokens at the config's own capacity factor:
    prefill's logits, K/V caches and pos, then one decode step's logits
    and cache, through both packages' step makers."""
    jcfg, jp = jax_models[arch]
    cfg = configs.get_reduced(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 17))
    cache_len = 21
    jl, jc = jax.jit(jstep.make_prefill_step(jcfg, cache_len=cache_len))(
        jp, {"tokens": jnp.asarray(toks[:, :-1])})
    jd, jc2 = jax.jit(jstep.make_decode_step(jcfg))(
        jp, jnp.asarray(toks[:, -1:], jnp.int32), jc)
    tp = _port(jp)
    tl, tc = tstep.make_prefill_step(cfg, cache_len=cache_len)(
        tp, {"tokens": torch.from_numpy(toks[:, :-1])})
    np.testing.assert_allclose(_np(tl), _np(jl), **BF16)
    assert int(tc["pos"]) == int(jc["pos"]) == 16
    for kv in ("k", "v"):
        got = tc["blocks"]["0"][kv]
        assert got.shape == jc["blocks"]["0"][kv].shape
        np.testing.assert_allclose(_np(got), _np(jc["blocks"]["0"][kv]),
                                   **BF16)
    td, tc2 = tstep.make_decode_step(cfg)(
        tp, torch.from_numpy(toks[:, -1:]).to(torch.int32), tc)
    np.testing.assert_allclose(_np(td), _np(jd), **BF16)
    assert int(tc2["pos"]) == int(jc2["pos"]) == 17
    np.testing.assert_allclose(_np(tc2["blocks"]["0"]["v"]),
                               _np(jc2["blocks"]["0"]["v"]), **BF16)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_full_forward_at_cf_8(arch):
    """Prefill S tokens then decode token S == prefill of S + 1 tokens,
    with the port's own weights, at capacity factor 8 (no drops: decode
    routes B tokens, prefill B * S, so their capacities differ)."""
    cfg = _with_cf(configs.get_reduced(arch), 8.0)
    params = TM.init_params(1, cfg, CPU)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 17)))
    prefill = tstep.make_prefill_step(cfg, cache_len=21)
    _, cache = prefill(params, {"tokens": toks[:, :-1]})
    logits_d, _ = tstep.make_decode_step(cfg)(params, toks[:, -1:], cache)
    logits_f, _ = prefill(params, {"tokens": toks})
    np.testing.assert_allclose(_np(logits_d[:, 0]), _np(logits_f[:, -1]),
                               **BF16)


# -- training ----------------------------------------------------------------

def _port_grads(params, batch, cfg, remat=True):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = TM.train_loss(live, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, cfg,
                              remat=remat)
    return loss, aux, torch.autograd.grad(loss, tree_leaves(live))


@pytest.mark.parametrize("arch", MOE)
def test_train_loss_and_grads_match_jax(jax_models, arch, monkeypatch):
    """`train_loss` = cross entropy + 0.01 aux in the f32 arm (JAX's
    ``CDTYPE`` patched, the weights upcast in both), its aux and each
    leaf's gradient; remat on and off give the same bits."""
    jcfg, jp = jax_models[arch]
    cfg = configs.get_reduced(arch)
    monkeypatch.setattr(JL, "CDTYPE", jnp.float32)
    jp = _f32(jp)
    batch = _batch(cfg, 0)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.train_loss(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jcfg),
        has_aux=True))(jp)
    params = _port(jp)
    loss, aux, grads = _port_grads(params, batch, cfg)
    loss = loss.detach()
    assert abs(float(loss) - float(jloss)) <= 1e-5
    aux_v = float(aux["aux"].detach())
    assert abs(aux_v - float(jaux["aux"])) <= 1e-5 * float(jaux["aux"])
    assert aux_v > 0
    assert abs(float(loss) - float(aux["xent"].detach()) - 0.01 * aux_v) \
        <= 1e-6
    names = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert any("router" in n for n in names)
    for name, got, want in zip(names, grads, jax.tree.leaves(jg)):
        assert got.dtype == torch.float32, name
        assert _rel(got, want) <= 1e-4, (name, _rel(got, want))
    l0, _, g0 = _port_grads(params, batch, cfg, remat=False)
    assert torch.equal(loss, l0)
    assert all(torch.equal(a, b) for a, b in zip(grads, g0))


def test_three_steps_track_jax(jax_models):
    """granite-moe reduced, 3 steps of n_micro 2 from JAX's start state
    in the f32 arm: each loss within 1e-5, params and moments within
    1e-4 relative a leaf, count 3."""
    from repro.data import pipeline as jpipe
    jcfg, jp = jax_models["granite-moe-1b-a400m"]
    cfg = configs.get_reduced("granite-moe-1b-a400m")
    orig = JL.CDTYPE
    JL.CDTYPE = jnp.float32
    try:
        step = jax.jit(jstep.make_train_step(
            jcfg, n_micro=2, opt_cfg=jadamw.AdamWConfig(**OPT)))
        data = jpipe.LMBatches(vocab=jcfg.vocab, batch=4, seq=16,
                               n_tokens=20_000, seed=0)
        jparams, jopt = _f32(jp), jadamw.init(_f32(jp))
        start = jax.tree.map(np.asarray, (jparams, jopt))
        losses = []
        for s in range(3):
            jparams, jopt, m = step(jparams, jopt, {
                k: jnp.asarray(v) for k, v in data.at(s).items()})
            losses.append(float(m["loss"]))
    finally:
        JL.CDTYPE = orig
    tstep_ = tstep.make_train_step(cfg, n_micro=2,
                                   opt_cfg=adamw.AdamWConfig(**OPT))
    params = params_from_numpy(start[0], CPU)
    opt = opt_state_from_numpy(start[1], CPU)
    for s in range(3):
        params, opt, m = tstep_(params, opt, {
            k: torch.from_numpy(v) for k, v in data.at(s).items()})
        assert abs(float(m["loss"]) - losses[s]) <= 1e-5
    for what, got, want in (("params", params, jparams),
                            ("mu", opt.mu, jopt.mu), ("nu", opt.nu, jopt.nu)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert _rel(a, b) <= 1e-4, (what, _rel(a, b))
    assert int(opt.count) == int(jopt.count) == 3


# -- the CLIs ----------------------------------------------------------------

def test_train_and_serve_clis_run_granite(capsys):
    """``launch.train`` and ``launch.serve`` on granite-moe reduced with
    ``--device cpu``: JAX's CLI lines, finite losses, a codebook."""
    arch = "granite-moe-1b-a400m"
    tlaunch.main(["--arch", arch, "--reduced", "--steps", "3", "--batch",
                  "4", "--seq", "16", "--device", "cpu", "--codebook", "8"])
    out = capsys.readouterr().out
    n = sum(t.numel() for t in tree_leaves(
        TM.init_params(0, configs.get_reduced(arch), CPU)))
    assert f"{arch} (reduced): {n:,} params" in out, out
    steps = re.findall(r"step +(\d+) loss (\S+) lr \S+ gnorm (\S+)", out)
    assert [s[0] for s in steps] == ["0", "2"], out
    assert all(np.isfinite(float(v)) for s in steps for v in s[1:])
    assert "embedding codebook (k=8): VQ-MSE" in out
    tserve.main(["--arch", arch, "--device", "cpu", "--gen", "4",
                 "--codebook", "8"])
    out = capsys.readouterr().out
    assert re.search(rf"{arch}: prefill 4x32 in [\d.]+ms; 3 decode steps",
                     out), out
    ids = re.search(r"generated token ids \(row 0\): \[(.*)\]", out)[1]
    assert len(ids.split(",")) == 4
    assert "codebook service:" in out

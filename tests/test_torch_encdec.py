"""The port's encdec (whisper) and vlm (internvl2) families against the JAX
package's, on the CPU.

`repro_torch.models.layers.{layer_norm,flash_attention(causal=False),
init_cross_attention,cross_kv,cross_attention_fwd}` and `models.model`'s
`sinusoid`, `sinusoid_at`, `encode` and the encdec and vlm branches of
init, prefill, decode and `train_loss`, at the reduced configs (whisper:
2 + 2 layers, d 64, 32 frames; internvl2: 2 layers, d 64, 8 patches).
JAX's weights come from ``PRNGKey(1)`` and are carried across with
`params_from_numpy`; tokens, frames and patches come from numpy seeds
(normal frames and patches: zeros would leave the encoder's input to
the sinusoid alone).

Each case runs a bf16 arm and an f32 arm (JAX's ``CDTYPE`` patched, the
weights upcast, the port's activations taking the weights' dtype).
JAX's jitted steps are compiled with ``xla_allow_excess_precision`` off
(`_exact_jit`, ROADMAP Queue 3 item 10). Tolerances, stated where held:
  * `layer_norm`: 1e-5 in f32; in bf16 one rounding apart (rtol 8e-3,
    a bf16 ulp is 2^-8 of the value);
  * `sinusoid`, `sinusoid_at` over 1536 positions: f32 within 2e-4
    absolute (XLA's and torch's f32 ``exp`` give 20 of whisper's 192
    frequencies one ulp apart, ~1.2e-7, and position 1535 scales that in
    the angle), bf16 one rounding apart (8e-3);
  * the attention and `encode`: f32 1e-5 (`encode` 1e-4: two layers of
    products summed in other orders), bf16 6e-2;
  * prefill and decode logits and caches: bf16 6e-2, f32 1e-4;
  * decode against the prefill one token longer, the port alone: bf16
    6e-2, f32 1e-4;
  * `train_loss` (f32 arm) within 1e-5, each gradient leaf within 1e-4
    relative (Frobenius).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import EncoderConfig as JEncoderConfig
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.configs.base import EncoderConfig
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import step as tstep
from repro_torch.util.tree import tree_leaves, tree_map

CPU = "cpu"
F32 = dict(rtol=1e-5, atol=1e-5)
F32_MODEL = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=6e-2, atol=6e-2)
BF16_ULP = dict(rtol=8e-3, atol=8e-3)
ARCHS = ["whisper-tiny", "internvl2-76b"]
ARMS = ["bf16", "f32"]


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


def _exact_jit(fn, *args):
    """JAX's jitted ``fn(*args)`` with every bf16 rounding the code
    writes (``xla_allow_excess_precision`` off)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_allow_excess_precision": False})(*args)


def _with_frontend(cfg, d_frontend: int, enc_cls):
    """``cfg`` with its encoder's frame embeddings ``d_frontend`` wide, so
    that `encode` takes ``enc_in``."""
    e = cfg.encoder
    return dataclasses.replace(cfg, encoder=enc_cls(
        n_layers=e.n_layers, n_ctx=e.n_ctx, d_frontend=d_frontend))


def _inputs(cfg, seed, B=2, S=12, dtype=jnp.bfloat16):
    """Tokens (B, S + 1) and the modality inputs (normal, numpy seed), as
    JAX arrays of ``dtype`` (the tokens int32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    extra = {}
    e = cfg.encoder
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(size=(B, e.n_ctx, e.d_frontend))
    if cfg.family == "vlm":
        extra["patches"] = rng.normal(size=(B, e.n_ctx, cfg.d_model))
    return toks, {k: jnp.asarray(v, dtype) for k, v in extra.items()}


@pytest.fixture(scope="module")
def jax_models():
    """{arch: (reduced config, JAX params from PRNGKey(1))}."""
    return {a: (jconfigs.get_reduced(a),
                JM.init_params(jax.random.PRNGKey(1),
                               jconfigs.get_reduced(a)))
            for a in ARCHS}


@pytest.fixture(params=ARMS)
def arm(request, monkeypatch):
    """The arm's JAX activation dtype; the f32 arm patches JAX's
    ``CDTYPE``."""
    if request.param == "f32":
        monkeypatch.setattr(JL, "CDTYPE", jnp.float32)
        return jnp.float32
    return jnp.bfloat16


def _arm_params(jp, dtype):
    return jp if dtype == jnp.bfloat16 else _f32(jp)


# -- layers ------------------------------------------------------------------

def test_layer_norm_matches_jax(arm):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 7, 48)) * 3 + 1, arm)
    scale = jnp.asarray(rng.normal(size=48), arm)
    bias = jnp.asarray(rng.normal(size=48), arm)
    want = JL.layer_norm(x, scale, bias, 1e-5)
    got = TL.layer_norm(_t(x), _t(scale), _t(bias), 1e-5)
    assert got.dtype == _t(x).dtype
    np.testing.assert_allclose(_np(got), _np(want),
                               **(F32 if arm == jnp.float32 else BF16_ULP))


def test_sinusoid_and_sinusoid_at_match_jax(arm):
    """`sinusoid` over 1536 positions (whisper's frames) at d = 384, and
    `sinusoid_at` at a few positions: JAX's values, and the port's
    `sinusoid_at(pos)` is its `sinusoid` row ``pos`` bit for bit."""
    d = 384
    tdt = torch.float32 if arm == jnp.float32 else torch.bfloat16
    tol = dict(rtol=0, atol=2e-4) if arm == jnp.float32 else BF16_ULP
    got = TM.sinusoid(1536, d, tdt)
    assert got.shape == (1536, d) and got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(JM.sinusoid(1536, d)), **tol)
    for pos in (0, 1, 47, 1535):
        row = TM.sinusoid_at(torch.tensor(pos, dtype=torch.int32), d, tdt)
        np.testing.assert_allclose(
            _np(row), _np(JM.sinusoid_at(jnp.asarray(pos, jnp.int32), d)),
            **tol)
        assert torch.equal(row, got[pos]), pos


def test_flash_attention_non_causal_over_uneven_chunks(arm):
    """``causal=False`` with q chunks of 16 and kv chunks of 24 over 48
    rows (3 q chunks across 2 kv chunks, as whisper's 1536 frames take
    chunks of 512 and 768), GQA 4 over 2, against JAX."""
    rng = np.random.default_rng(1)
    q, k, v = (jnp.asarray(rng.normal(size=(2, 48, h, 16)), arm)
               for h in (4, 2, 2))
    kw = dict(causal=False, q_chunk=16, kv_chunk=24)
    want = JL.flash_attention(q, k, v, **kw)
    tdt = _t(q).dtype
    got = TL.flash_attention(_t(q), _t(k), _t(v), cdtype=tdt, **kw)
    np.testing.assert_allclose(
        _np(got), _np(want), **(F32 if arm == jnp.float32 else BF16))
    # the same attention in one chunk
    one = TL.flash_attention(_t(q), _t(k), _t(v), causal=False, cdtype=tdt)
    np.testing.assert_allclose(_np(got), _np(one), **(
        F32 if arm == jnp.float32 else BF16))


def test_cross_attention_matches_jax(jax_models, arm):
    """`cross_kv` of an encoder output and `cross_attention_fwd` of the
    decoder's rows against it, with whisper reduced's first cross
    attention."""
    cfg, jp = jax_models["whisper-tiny"]
    xp = jax.tree.map(lambda w: w[0], jp["blocks"]["0"]["xattn"])
    xp = _arm_params(xp, arm)
    rng = np.random.default_rng(3)
    enc = jnp.asarray(rng.normal(size=(2, cfg.encoder.n_ctx, cfg.d_model)),
                      arm)
    x = jnp.asarray(rng.normal(size=(2, 9, cfg.d_model)), arm)
    jkv = JL.cross_kv(xp, enc, cfg)
    want = JL.cross_attention_fwd(xp, x, jkv, cfg)
    tp = {k: _t(w) for k, w in xp.items()}
    tkv = TL.cross_kv(tp, _t(enc), cfg)
    got = TL.cross_attention_fwd(tp, _t(x), tkv, cfg)
    tol = F32 if arm == jnp.float32 else BF16
    for g, w in zip(tkv, jkv):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), **tol)
    assert got.shape == (2, 9, cfg.d_model) and got.dtype == _t(x).dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("d_frontend", [None, 48])
def test_encode_matches_jax(arm, d_frontend):
    """The whisper encoder over normal frames; with ``d_frontend`` 48 (not
    d_model 64) the frames go through ``enc_in`` first."""
    jcfg = jconfigs.get_reduced("whisper-tiny")
    cfg = configs.get_reduced("whisper-tiny")
    if d_frontend is not None:
        jcfg = _with_frontend(jcfg, d_frontend, JEncoderConfig)
        cfg = _with_frontend(cfg, d_frontend, EncoderConfig)
    jp = _arm_params(JM.init_params(jax.random.PRNGKey(2), jcfg), arm)
    assert ("enc_in" in jp) == (d_frontend is not None)
    _, extra = _inputs(cfg, 4)
    want = _exact_jit(functools.partial(JM.encode, cfg=jcfg), jp,
                      extra["frames"])
    got = TM.encode(_port(jp), _t(extra["frames"]), cfg)
    assert got.shape == (2, cfg.encoder.n_ctx, cfg.d_model)
    assert got.dtype == (torch.float32 if arm == jnp.float32
                         else torch.bfloat16)
    np.testing.assert_allclose(
        _np(got), _np(want), **(F32_MODEL if arm == jnp.float32 else BF16))


# -- the models --------------------------------------------------------------

@pytest.mark.parametrize("arch,d_frontend", [("whisper-tiny", None),
                                             ("whisper-tiny", 48),
                                             ("internvl2-76b", None)])
def test_param_tree_matches_jax(arch, d_frontend):
    """The port's tree has JAX's keys, shapes and dtypes (the encoder,
    ``enc_in``, ``xattn`` and ``ln_x`` of encdec; the vlm's a dense
    decoder's), and `params_from_numpy` carries JAX's leaves bit for
    bit."""
    jcfg = jconfigs.get_reduced(arch)
    cfg = configs.get_reduced(arch)
    if d_frontend is not None:
        jcfg = _with_frontend(jcfg, d_frontend, JEncoderConfig)
        cfg = _with_frontend(cfg, d_frontend, EncoderConfig)
    got = TM.init_params(0, cfg, CPU)
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(tree_leaves(got)) == len(paths)
    for leaf, (path, spec) in zip(tree_leaves(got), paths):
        name = jax.tree_util.keystr(path)
        assert tuple(leaf.shape) == spec.shape, name
        assert str(leaf.dtype).replace("torch.", "") == str(spec.dtype), name
    n = sum(x.numel() for x in tree_leaves(got))
    extra = (4 * cfg.d_model ** 2 + cfg.d_model) * cfg.n_layers \
        if cfg.family == "encdec" else 0
    if "enc_in" in got:
        extra += cfg.encoder.d_frontend * cfg.d_model
    # param_count() counts neither the cross attention and its norm nor
    # the final norm and enc_in
    assert n == cfg.param_count() + cfg.d_model + extra
    host = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1),
                                                   jcfg))
    carried = params_from_numpy(host, CPU)
    for x, y in zip(tree_leaves(carried), jax.tree.leaves(host)):
        assert str(x.dtype).replace("torch.", "") == str(y.dtype)
        np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                      y.view(np.int16))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(jax_models, arch, arm):
    """The same weights, tokens and frames or patches: prefill's logits
    and cache (K/V rows, pos, whisper's ``enc_out``), then one decode
    step's logits and cache. The vlm's cache holds its 8 patches before
    the prompt."""
    jcfg, jp = jax_models[arch]
    jp = _arm_params(jp, arm)
    cfg = configs.get_reduced(arch)
    toks, extra = _inputs(cfg, 2, dtype=jnp.bfloat16)
    prefix = cfg.encoder.n_ctx if cfg.family == "vlm" else 0
    S = toks.shape[1] - 1 + prefix
    cache_len = S + 4
    jl, jc = _exact_jit(jstep.make_prefill_step(jcfg, cache_len=cache_len),
                        jp, {"tokens": jnp.asarray(toks[:, :-1]), **extra})
    jd, jc2 = _exact_jit(jstep.make_decode_step(jcfg), jp,
                         jnp.asarray(toks[:, -1:]), jc)
    tp = _port(jp)
    tl, tc = tstep.make_prefill_step(cfg, cache_len=cache_len)(
        tp, {"tokens": torch.from_numpy(toks[:, :-1]),
             **{k: _t(v) for k, v in extra.items()}})
    tol = F32_MODEL if arm == jnp.float32 else BF16
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert int(tc["pos"]) == int(jc["pos"]) == S
    assert sorted(tc) == sorted(jc)
    if cfg.family == "encdec":
        np.testing.assert_allclose(_np(tc["enc_out"]), _np(jc["enc_out"]),
                                   **tol)
    want_leaves = jax.tree_util.tree_flatten_with_path(jc["blocks"])[0]
    for got, (path, want) in zip(tree_leaves(tc["blocks"]), want_leaves):
        name = jax.tree_util.keystr(path)
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        assert not bool(got[:, :, S:].any()), name
    td, tc2 = tstep.make_decode_step(cfg)(
        tp, torch.from_numpy(toks[:, -1:]), tc)
    np.testing.assert_allclose(_np(td), _np(jd), **tol)
    assert int(tc2["pos"]) == int(jc2["pos"]) == S + 1
    for got, want in zip(tree_leaves(tc2["blocks"]),
                         jax.tree.leaves(jc2["blocks"])):
        np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_matches_full_forward(arch, dtype):
    """Prefill S tokens then decode token S == prefill of S + 1 tokens,
    with the port's own weights (upcast in the f32 arm): whisper's decode
    adds `sinusoid_at(S)` where the prefill's `sinusoid` has row S, and
    attends to the cached ``enc_out``; the vlm's positions count its
    patches. The decode writes its K/V row into the cache in place."""
    cfg = configs.get_reduced(arch)
    params = tree_map(lambda w: w.to(dtype), TM.init_params(1, cfg, CPU))
    toks, extra = _inputs(cfg, 5)
    toks = torch.from_numpy(toks)
    extra = {k: _t(v) for k, v in extra.items()}
    prefix = cfg.encoder.n_ctx if cfg.family == "vlm" else 0
    S = toks.shape[1] - 1 + prefix
    prefill = tstep.make_prefill_step(cfg, cache_len=S + 3)
    _, cache = prefill(params, {"tokens": toks[:, :-1], **extra})
    k_before = cache["blocks"]["0"]["k"]
    assert k_before.dtype == dtype
    logits_d, new = tstep.make_decode_step(cfg)(params, toks[:, -1:], cache)
    logits_f, full = prefill(params, {"tokens": toks, **extra})
    tol = F32_MODEL if dtype == torch.float32 else BF16
    np.testing.assert_allclose(_np(logits_d[:, 0]), _np(logits_f[:, -1]),
                               **tol)
    assert new["blocks"]["0"]["k"] is k_before
    np.testing.assert_allclose(_np(k_before[:, :, :S + 1]),
                               _np(full["blocks"]["0"]["k"][:, :, :S + 1]),
                               **tol)


def _port_grads(params, batch, cfg, remat=True):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, aux = TM.train_loss(live, batch, cfg, remat=remat)
    return loss.detach(), aux, torch.autograd.grad(loss, tree_leaves(live))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(jax_models, arch, monkeypatch):
    """The f32 arm (JAX's ``CDTYPE`` patched, the weights upcast): the
    loss, with the vlm's patch prefix stripped before it, and each leaf's
    gradient (the encoder's and ``enc_in``-free frames' path, the
    cross attention's); remat on and off give the same bits."""
    jcfg, jp = jax_models[arch]
    cfg = configs.get_reduced(arch)
    monkeypatch.setattr(JL, "CDTYPE", jnp.float32)
    jp = _f32(jp)
    toks, extra = _inputs(cfg, 0, S=16, dtype=jnp.float32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                   # masked positions
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(labels), **extra}
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.train_loss(p, jbatch, jcfg), has_aux=True))(jp)
    tbatch = {k: (_t(v) if k in extra else torch.from_numpy(np.array(v)))
              for k, v in jbatch.items()}
    params = _port(jp)
    loss, _, grads = _port_grads(params, tbatch, cfg)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    names = [jax.tree_util.keystr(k)
             for k, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    assert len(grads) == len(names)
    for name, got, want in zip(names, grads, jax.tree.leaves(jg)):
        assert got.dtype == torch.float32, name
        assert _rel(got, want) <= 1e-4, (name, _rel(got, want))
    l0, _, g0 = _port_grads(params, tbatch, cfg, remat=False)
    assert torch.equal(loss, l0)
    assert all(torch.equal(a, b) for a, b in zip(grads, g0))

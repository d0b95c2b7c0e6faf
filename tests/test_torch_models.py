"""The port's dense model against the JAX package's, on the CPU.

`repro_torch.configs`, `repro_torch.models.{layers,model}`,
`repro_torch.train.step` and `convert.params_from_numpy`. JAX's weights
are made from ``PRNGKey(1)`` and carried across with `params_from_numpy`
(bf16 bit-cast through int16), so both packages compute with the same
numbers; tokens and activations come from a numpy seed.

Tolerances: `rms_norm`, `apply_rope`, `flash_attention` and
`decode_attention` on f32 inputs at rtol=atol=1e-5. Both packages round
the attention's operands to the compute dtype (bf16) and take f32
products of them; the attention cases also run with float32 operands
(JAX's ``CDTYPE`` and the port's ``cdtype``), where every product is a
true f32 one. The
models' logits and caches at rtol=atol=6e-2 (bf16 activations, as
tests/test_models.py holds decode against the full forward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.train import step as jstep
from repro_torch import configs
from repro_torch.configs.base import replace
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.train import step as tstep

CPU = "cpu"
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=6e-2, atol=6e-2)
DENSE = ["tinyllama-1.1b", "llama3.2-3b", "codeqwen1.5-7b", "qwen1.5-32b"]


def _bf16(x) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor (exact through f32)."""
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.fixture(scope="module")
def jax_models():
    """{arch: (reduced config, JAX params from PRNGKey(1))}."""
    return {a: (jconfigs.get_reduced(a),
                JM.init_params(jax.random.PRNGKey(1),
                               jconfigs.get_reduced(a)))
            for a in DENSE}


# -- configs -----------------------------------------------------------------

def test_configs_equal_jax():
    """Every architecture (full and reduced) and k-means workload is the
    JAX package's, field for field, and ``--arch`` offers the same
    choices."""
    assert configs.list_archs() == jconfigs.list_archs()
    for a in jconfigs.list_archs():
        for get in ("get_config", "get_reduced"):
            got = dataclasses.asdict(getattr(configs, get)(a))
            assert got == dataclasses.asdict(getattr(jconfigs, get)(a)), a
        assert (configs.get_config(a).param_count()
                == jconfigs.get_config(a).param_count())
    for name in jconfigs.KMEANS_WORKLOADS:
        assert (dataclasses.asdict(configs.get_kmeans_config(name))
                == dataclasses.asdict(jconfigs.get_kmeans_config(name)))
    cfg = replace(configs.get_config("tinyllama-1.1b"), n_layers=3)
    assert cfg.n_layers == 3 and cfg.d_model == 2048


def test_param_counts_match_configs():
    """The port's analytic param_count ~ the advertised model size (as
    tests/test_models.py holds JAX's)."""
    expected = {"tinyllama-1.1b": 1.1e9, "llama3.2-3b": 3.2e9,
                "codeqwen1.5-7b": 7.2e9, "qwen1.5-32b": 32e9,
                "mamba2-2.7b": 2.7e9, "jamba-v0.1-52b": 52e9,
                "qwen3-moe-235b-a22b": 235e9,
                "granite-moe-1b-a400m": 1.3e9, "internvl2-76b": 76e9}
    for arch, n in expected.items():
        got = configs.get_config(arch).param_count()
        assert 0.7 * n < got < 1.45 * n, (arch, got, n)
    a22 = configs.get_config("qwen3-moe-235b-a22b").active_param_count()
    assert 15e9 < a22 < 30e9, a22


# -- layers ------------------------------------------------------------------

def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 24, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                    1e-5).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)),
        **F32)
    pos = np.arange(24)[None] + 7
    for theta in (10000.0, 1e6):
        np.testing.assert_allclose(
            TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          theta).numpy(),
            np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                     theta)), **F32)
        np.testing.assert_allclose(TL.rope_freqs(16, theta).numpy(),
                                   np.asarray(JL.rope_freqs(16, theta)),
                                   **F32)


@pytest.fixture(params=["bf16_operands", "f32"])
def compute_dtype(request, monkeypatch):
    """The attention's operand dtype in both packages, returned as the
    port's ``cdtype``: their default (bf16 operands, f32 products) or
    float32 throughout (JAX's module constant ``CDTYPE`` patched)."""
    if request.param == "f32":
        monkeypatch.setattr(JL, "CDTYPE", jnp.float32)
        return torch.float32
    return TL.CDTYPE


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(compute_dtype, causal):
    """3 q chunks over 4 kv chunks, GQA (4 heads over 2), q_offset 16."""
    rng = np.random.default_rng(1)
    B, Sq, Skv, H, KV, Dh = 2, 48, 64, 4, 2, 16
    q = rng.normal(size=(B, Sq, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, Skv, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, Skv, KV, Dh)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=16, kv_chunk=16, q_offset=16)
    got = TL.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw,
                             cdtype=compute_dtype)
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_attention_guards_fully_masked_rows():
    """q_offset -16 leaves the first 16 query rows no key: they come out
    0 (the 1e-30 floor), as in JAX, never NaN."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.normal(size=(1, 32, 2, 8)).astype(np.float32)
               for _ in range(3))
    kw = dict(causal=True, q_chunk=8, kv_chunk=8, q_offset=-16)
    got = TL.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    assert bool(torch.isfinite(got).all())
    assert not bool(got[:, :16].any())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("pos", [0, 21, 39])
def test_decode_attention_matches_jax(compute_dtype, pos):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
              for _ in range(2))
    got = TL.decode_attention(*map(torch.from_numpy, (q, kc, vc)),
                              torch.tensor(pos, dtype=torch.int32),
                              cdtype=compute_dtype)
    want = JL.decode_attention(*map(jnp.asarray, (q, kc, vc)),
                               jnp.asarray(pos, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_mlp_and_pick_chunk_match_jax(jax_models):
    cfg, jp = jax_models["tinyllama-1.1b"]
    mlp = jax.tree.map(lambda w: w[0], jp["blocks"]["0"]["mlp"])
    x = np.random.default_rng(4).normal(size=(2, 8, cfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    want = JL.mlp_fwd(mlp, xj)
    got = TL.mlp_fwd({k: _bf16(w) for k, w in mlp.items()}, _bf16(xj))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)
    for S, target in ((48, 16), (33, 512), (35, 16), (7, 1)):
        assert TL._pick_chunk(S, target) == JL._pick_chunk(S, target)


# -- the model ---------------------------------------------------------------

def _tree_shapes(tree):
    if isinstance(tree, dict):
        return {k: _tree_shapes(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", DENSE)
def test_param_tree_matches_jax(arch):
    """`init_params` builds JAX's tree: the same keys, shapes (blocks
    stacked over periods) and dtypes, so the same count."""
    cfg = configs.get_reduced(arch)
    got = TM.init_params(0, cfg, CPU)
    want = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                 jconfigs.get_reduced(arch)))
    assert _tree_shapes(got) == _tree_shapes(want)
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(want))
    assert sum(t.numel() for t in jax.tree.leaves(got)) == n
    d = cfg.d_model
    # JAX's param_count counts no final norm
    assert n == cfg.param_count() + d


def test_init_params_is_seeded():
    cfg = configs.get_reduced("tinyllama-1.1b")
    a, b = TM.init_params(3, cfg, CPU), TM.init_params(3, cfg, CPU)
    c = TM.init_params(4, cfg, CPU)
    for x, y, z in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                       jax.tree.leaves(c)):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)
    assert not torch.equal(a["embed"], c["embed"])
    std = float(a["embed"].float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_params_from_numpy_keeps_the_bits(jax_models):
    _, jp = jax_models["qwen1.5-32b"]
    host = jax.tree.map(np.asarray, jp)
    got = params_from_numpy(host, CPU)
    assert "bq" in got["blocks"]["0"]["attn"]
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(host)):
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.view(torch.int16).numpy(),
                                      y.view(np.int16))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(jax_models, arch):
    """The same weights and tokens: prefill's logits, K/V caches and pos,
    then one decode step's logits, through both packages' step makers."""
    jcfg, jp = jax_models[arch]
    cfg = configs.get_reduced(arch)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 17))
    cache_len = 21
    jl, jc = jax.jit(jstep.make_prefill_step(jcfg, cache_len=cache_len))(
        jp, {"tokens": jnp.asarray(toks[:, :-1])})
    jd, jc2 = jax.jit(jstep.make_decode_step(jcfg))(
        jp, jnp.asarray(toks[:, -1:], jnp.int32), jc)

    tp = params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    tl, tc = tstep.make_prefill_step(cfg, cache_len=cache_len)(
        tp, {"tokens": torch.from_numpy(toks[:, :-1])})
    assert tl.shape == (2, 1, cfg.vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **BF16)
    assert int(tc["pos"]) == int(jc["pos"]) == 16
    for kv in ("k", "v"):
        got = tc["blocks"]["0"][kv]
        assert got.shape == jc["blocks"]["0"][kv].shape
        np.testing.assert_allclose(_np(got), _np(jc["blocks"]["0"][kv]),
                                   **BF16)
        assert not bool(got[:, :, 16:].any())
    td, tc2 = tstep.make_decode_step(cfg)(
        tp, torch.from_numpy(toks[:, -1:]).to(torch.int32), tc)
    np.testing.assert_allclose(_np(td), _np(jd), **BF16)
    assert int(tc2["pos"]) == int(jc2["pos"]) == 17
    np.testing.assert_allclose(_np(tc2["blocks"]["0"]["k"]),
                               _np(jc2["blocks"]["0"]["k"]), **BF16)


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_full_forward(arch):
    """Prefill S tokens then decode token S == prefill of S+1 tokens
    (tests/test_models.py's property, inside the port), with the port's
    own weights; the decode writes its K/V row into the cache in place."""
    cfg = configs.get_reduced(arch)
    params = TM.init_params(1, cfg, CPU)
    toks = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 17)))
    prefill = tstep.make_prefill_step(cfg, cache_len=21)
    _, cache = prefill(params, {"tokens": toks[:, :-1]})
    k_before = cache["blocks"]["0"]["k"]
    logits_d, new = tstep.make_decode_step(cfg)(params, toks[:, -1:], cache)
    logits_f, full = prefill(params, {"tokens": toks})
    np.testing.assert_allclose(_np(logits_d[:, 0]), _np(logits_f[:, -1]),
                               **BF16)
    # donated: the same storage now holds row 16
    assert new["blocks"]["0"]["k"] is k_before
    assert bool(k_before[:, :, 16].any()) and not bool(k_before[:, :, 17:]
                                                       .any())
    np.testing.assert_allclose(_np(k_before[:, :, :17]),
                               _np(full["blocks"]["0"]["k"][:, :, :17]),
                               **BF16)


def test_device_defaults_to_the_card():
    cfg = configs.get_reduced("tinyllama-1.1b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({"embed": np.zeros((2, 2), np.float32)})

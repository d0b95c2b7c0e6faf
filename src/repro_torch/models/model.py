"""The model zoo: init, training loss, prefill and decode, for all six
families.

Port of `repro/models/model.py`. Layers are stacked per *period
position*, with a leading ``n_periods`` dimension, as in JAX, so a JAX
parameter tree maps onto the port's one to one
(`repro_torch.convert.params_from_numpy`). JAX scans the stack; the port
loops over the periods, each a slice of one `torch.unbind` of the stack
(so a backward pass stacks the periods' gradients once), and over the
positions within each.

  family    period   position structure
  dense      1       [attn + mlp]
  moe(all)   1       [attn + moe]
  moe(alt)   2       [attn + mlp, attn + moe]
  ssm        1       [mamba]
  hybrid     8       [attn|mamba at t==0|t>0; moe on odd t]   (jamba)
  encdec     1       encoder [bidir attn + mlp], decoder
                     [self attn + cross attn + mlp]           (whisper)
  vlm        1       dense decoder + patch-embedding prefix   (internvl2)

``backbone_full(..., remat=True)`` (training) runs each period under
`torch.utils.checkpoint.checkpoint` (non-reentrant): its activations are
recomputed in the backward pass instead of kept. JAX's remat policy
(``dots_with_no_batch_dims_saveable``) only chooses what is kept, so
remat on and off give the same bits. Serving runs without it.

The encdec family takes precomputed frame embeddings (``batch["frames"]``,
(B, n_ctx, d_frontend)) through its encoder; its decoder adds sinusoidal
positions and runs without RoPE. The vlm family prefixes precomputed
patch embeddings (``batch["patches"]``, (B, n_ctx, d_model)) to the
tokens, with positions over the whole sequence, and strips the prefix
before the loss.

Under a device mesh (`layers.use_mesh`) `train_loss` runs sharded: each
period's weights are gathered as it runs (`layers.gathered`), the
residual stream is constrained where JAX constrains it, the embedding
and the logits are vocab-parallel where the vocabulary divides the
"model" dim, and the loss is the global batch's mean on every rank.
`prefill` and `decode_step` run sharded the same way: the cache is this
rank's blocks as `sharding.cache_specs` lays them out (K/V heads over
"model" where they divide it, else the positions; the SSM and conv states
of the rank's heads), and the logits are the rank's block of the
vocabulary where it divides "model".

Entry points: init_params / train_loss / prefill / make_decode_cache /
decode_step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.kernels._build import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]

# --------------------------------------------------------------------------
# period structure
# --------------------------------------------------------------------------

def period_len(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.hybrid_period
    if cfg.moe is not None and cfg.moe.layout == "alternate":
        return 2
    return 1


def n_periods(cfg: ModelConfig) -> int:
    pl = period_len(cfg)
    assert cfg.n_layers % pl == 0, (cfg.n_layers, pl)
    return cfg.n_layers // pl


def pos_is_attn(cfg: ModelConfig, t: int) -> bool:
    return cfg.is_attention_layer(t)


def pos_is_moe(cfg: ModelConfig, t: int) -> bool:
    return cfg.is_moe_layer(t)


def pos_has_ffn(cfg: ModelConfig, t: int) -> bool:
    return cfg.family != "ssm"


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_position(gen: torch.Generator, cfg: ModelConfig, t: int) -> Params:
    """Params for one layer at period-position t."""
    d = cfg.d_model
    ones = torch.ones((d,), dtype=L.PDTYPE, device=gen.device)
    p: Params = {"ln1": ones}
    if pos_is_attn(cfg, t):
        p["attn"] = L.init_attention(gen, cfg)
    else:
        p["mamba"] = L.init_mamba(gen, d, cfg.ssm)
    if cfg.family == "encdec":
        p["ln_x"] = ones.clone()
        p["xattn"] = L.init_cross_attention(gen, cfg)
    if pos_has_ffn(cfg, t):
        p["ln2"] = ones.clone()
        if pos_is_moe(cfg, t):
            p["moe"] = L.init_moe(gen, d, cfg.moe)
        else:
            p["mlp"] = L.init_mlp(gen, d, cfg.d_ff)
    return p


def _stack(trees):
    """Leaf-wise `torch.stack` of equally shaped trees (dicts, tuples)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(_stack(list(z)) for z in zip(*trees))
    return torch.stack(trees)


def _init_stacked(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Params]:
    """{pos_t: params stacked over periods}, keyed "0".."pl-1" as in
    JAX."""
    return {str(t): _stack([_init_position(gen, cfg, t)
                            for _ in range(n_periods(cfg))])
            for t in range(period_len(cfg))}


def _init_encoder(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Whisper-style encoder stack (bidirectional, sinusoidal positions),
    stacked over its layers, without attention biases."""
    enc_cfg = dataclasses.replace(cfg, attn_bias=False)
    d = cfg.d_model

    def one():
        ones = torch.ones((d,), dtype=L.PDTYPE, device=gen.device)
        return {"ln1": ones, "attn": L.init_attention(gen, enc_cfg),
                "ln2": ones.clone(), "mlp": L.init_mlp(gen, d, cfg.d_ff)}

    return _stack([one() for _ in range(cfg.encoder.n_layers)])


def init_params(seed: int, cfg: ModelConfig, device="cuda") -> Params:
    """Random weights from ``seed`` on ``device``: the JAX package's tree
    and distributions (N(0, 1) scaled by fan-in^-0.5, bf16; the router
    and the SSD's decay leaves f32), drawn from one `torch.Generator` on
    the device (so not JAX's numbers)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d, v = cfg.d_model, cfg.vocab
    p: Params = {
        "embed": L.dense_init(gen, v, d, scale=d ** -0.5),
        "blocks": _init_stacked(gen, cfg),
        "ln_f": torch.ones((d,), dtype=L.PDTYPE, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, v)
    if cfg.family == "encdec":
        p["encoder"] = _init_encoder(gen, cfg)
        if cfg.encoder.d_frontend != d:
            p["enc_in"] = L.dense_init(gen, cfg.encoder.d_frontend, d)
    return p


def _periods(tree, n: int):
    """The ``n`` periods' slices of a tree stacked over periods: views,
    one `torch.unbind` a leaf, whose backward stacks the periods'
    gradients in one step."""
    if isinstance(tree, dict):
        parts = {k: _periods(x, n) for k, x in tree.items()}
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return torch.unbind(tree)


# --------------------------------------------------------------------------
# sinusoidal positions (whisper)
# --------------------------------------------------------------------------

def _sinusoid_div(d: int, device) -> torch.Tensor:
    step = -(torch.log(torch.tensor(1e4, device=device)) / d)
    return torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) * step)


def sinusoid(S: int, d: int, dtype: torch.dtype = L.CDTYPE,
             device="cpu") -> torch.Tensor:
    """(S, d) sinusoidal positions (sin at even, cos at odd features),
    computed in f32 and rounded to ``dtype``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    ang = pos * _sinusoid_div(d, device)
    pe = torch.zeros((S, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe.to(dtype)


def sinusoid_at(pos: torch.Tensor, d: int,
                dtype: torch.dtype = L.CDTYPE) -> torch.Tensor:
    """(d,) `sinusoid`'s row at the 0-d position ``pos`` (a tensor, so a
    decode step reads it on the device)."""
    ang = pos.float() * _sinusoid_div(d, pos.device)
    pe = torch.zeros((d,), dtype=torch.float32, device=pos.device)
    pe[0::2] = torch.sin(ang)
    pe[1::2] = torch.cos(ang)
    return pe.to(dtype)


# --------------------------------------------------------------------------
# forward: full-sequence (train / prefill)
# --------------------------------------------------------------------------

def _ffn(p: Params, x, cfg: ModelConfig, t: int):
    """The position's feed-forward half on ``x``: (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if pos_has_ffn(cfg, t):
        h_in = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if pos_is_moe(cfg, t):
            h, a = L.moe_fwd(p["moe"], h_in, cfg.moe)
            aux = aux + a
        else:
            h = L.mlp_fwd(p["mlp"], h_in)
        x = x + h
    return x, aux


def _cross(p: Params, x, enc_out, cfg: ModelConfig):
    """The encdec decoder's cross attention on ``x`` against the
    encoder's output (its K/V taken from ``enc_out`` on each call, as
    JAX takes them)."""
    return L.cross_attention_fwd(
        p["xattn"], L.rms_norm(x, p["ln_x"], cfg.norm_eps),
        L.cross_kv(p["xattn"], enc_out, cfg), cfg)


def _layer_full(p: Params, x, cfg: ModelConfig, t: int, *, positions,
                enc_out, want_cache: bool):
    """One layer at period-position t, full sequence. Returns (x, aux,
    cache entry): ``{"kv": (k, v)}`` or ``{"ssm": {"ssm", "conv"}}`` with
    ``want_cache``, else ``{}``."""
    cache = {}
    h_in = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if pos_is_attn(cfg, t):
        h, kv = L.attention_fwd(p["attn"], h_in, cfg, positions=positions,
                                use_rope=cfg.family != "encdec")
        if want_cache:
            cache["kv"] = kv
    else:
        h = L.mamba_fwd(p["mamba"], h_in, cfg.ssm, cfg.d_model,
                        return_state=want_cache)
        if want_cache:
            h, cache["ssm"] = h
    x = x + h
    if cfg.family == "encdec":
        x = x + _cross(p, x, enc_out, cfg)
    x, aux = _ffn(p, x, cfg, t)
    return x, aux, cache


def _period_full(pp: Params, x, cfg: ModelConfig, *, positions, enc_out,
                 want_cache: bool):
    """One period's positions in turn: (x, aux summed in f32, {t: cache
    entry}). Under a mesh the period's weights are gathered first."""
    pp = L.gathered(pp, "blocks", stacked=True)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}
    for t in range(period_len(cfg)):
        x, a, c = _layer_full(pp[str(t)], x, cfg, t, positions=positions,
                              enc_out=enc_out, want_cache=want_cache)
        x = L.constrain(x, "dp", None, None)
        aux = aux + a
        if c:
            caches[str(t)] = c
    return x, aux, caches


def _period_under(amb, pp: Params, x, cfg: ModelConfig, **kw):
    """`_period_full` under the ambient ``amb`` (a checkpointed period's
    recompute runs on autograd's thread)."""
    with L.restored(amb):
        return _period_full(pp, x, cfg, **kw)


def _stack_caches(per_period):
    """[{t: entry}] over the periods -> {t: entry stacked over them}."""
    return {t: _stack([c[t] for c in per_period]) for t in per_period[0]}


def backbone_full(params: Params, x, cfg: ModelConfig, *, positions,
                  enc_out=None, want_cache: bool = False,
                  remat: bool = True, keep=None):
    """Run the stacked blocks over a full sequence, period by period.
    Returns (x, aux, caches): aux is the periods' MoE aux losses summed
    in f32, in JAX's order; with ``want_cache``, ``caches[t]`` is
    position t's entry (``"kv"``: (k, v) of (n_periods, B, S, KV, Dh);
    ``"ssm"``: the SSM and conv states) stacked over the periods.
    ``enc_out`` is the encdec encoder's output. ``remat`` recomputes
    each period's activations in the backward pass (it changes no
    value). ``keep``: a function of a period's cache entries ({t: entry})
    that gives what is kept of them (the sharded prefill keeps its block
    of positions)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kept = []
    for pp in _periods(params["blocks"], n_periods(cfg)):
        if remat:
            x, a, c = checkpoint(_period_under, L.ambient(), pp, x, cfg,
                                 positions=positions, enc_out=enc_out,
                                 want_cache=want_cache, use_reentrant=False)
        else:
            x, a, c = _period_full(pp, x, cfg, positions=positions,
                                   enc_out=enc_out, want_cache=want_cache)
        aux = aux + a
        if want_cache:
            kept.append(c if keep is None else keep(c))
    return x, aux, (_stack_caches(kept) if want_cache else {})


def encode(params: Params, frames, cfg: ModelConfig):
    """Whisper encoder: precomputed frame embeddings (B, n_ctx,
    d_frontend) -> context (B, n_ctx, d_model), in the parameters'
    dtype."""
    x = frames.to(params["embed"].dtype)
    if "enc_in" in params:
        x = x @ _top(params, "enc_in")[0]
    S = x.shape[1]
    x = x + sinusoid(S, cfg.d_model, x.dtype, x.device)[None]
    positions = torch.arange(S, device=x.device)[None]
    for p in _periods(params["encoder"], cfg.encoder.n_layers):
        p = L.gathered(p, "encoder", stacked=True)
        h, _ = L.attention_fwd(
            p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
            positions=positions, causal=False, use_rope=False)
        x = x + h
        x = x + L.mlp_fwd(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x


def _top(params: Params, name: str):
    """(the compute weight of top-level leaf ``name``, whether it is this
    rank's block over "model") under the ambient mesh (`L.gathered`)."""
    p = L.gathered({name: params[name]}, "")
    return p[name], L._tp(p, name)


def _embed(table: torch.Tensor, tokens: torch.Tensor, sharded: bool):
    """``table[tokens]``; where ``table`` is this rank's block of the
    vocabulary, its rows for the tokens in the block and zeros for the
    rest, summed over "model" (one nonzero term a token: exact)."""
    if not sharded:
        return table[tokens]
    mesh = L._ambient_mesh()
    lo = C.axis_index(mesh, "model") * table.shape[0]
    loc = tokens - lo
    mine = (loc >= 0) & (loc < table.shape[0])
    rows = table[torch.where(mine, loc, 0)]
    return C.sum_over(torch.where(mine[..., None], rows, 0.0), mesh, "model")


def embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig):
    """tokens (+ modality prefix) -> (x, positions, enc_out). The
    activations take the parameters' dtype: bf16, JAX's ``PDTYPE`` and
    ``CDTYPE``; f32 for upcast weights."""
    tokens = batch["tokens"]
    table, sharded = _top(params, "embed")
    x = _embed(table, tokens, sharded)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = encode(params, batch["frames"], cfg)
        x = x + sinusoid(x.shape[1], cfg.d_model, x.dtype, x.device)[None]
    if cfg.family == "vlm":
        # precomputed patch embeddings prefixed to the token sequence
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    x = L.constrain(x, "dp", None, None)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    return x, positions, enc_out


def _head(params: Params, cfg: ModelConfig):
    """(the output projection (D, V), whether it is this rank's block of
    the vocabulary)."""
    if cfg.tie_embeddings:
        w, sharded = _top(params, "embed")
        return w.T, sharded
    return _top(params, "lm_head")


def logits_fn(params: Params, x, cfg: ModelConfig):
    """f32 logits; under a mesh this rank's block of the vocabulary where
    the output projection holds one."""
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    w, sharded = _head(params, cfg)
    return L.constrain((L._enter(x, sharded) @ w).float(), "dp", None, "tp")


def _xent_parts(logits, lab, sharded: bool):
    """(logsumexp, gold logit) a position. Over a block of the
    vocabulary they come from the blocks' maxima, sums of exponentials
    and masked sums, summed over "model" (an explicit sharded
    log-softmax: a rank holds only its (B, S, V / tp) block)."""
    if not sharded:
        logz = torch.logsumexp(logits, dim=-1)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        return logz, torch.where(vocab == lab[..., None], logits, 0.0).sum(-1)
    mesh = L._ambient_mesh()
    m = C.pmax(torch.amax(logits.detach(), dim=-1), mesh, "model")
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    logz = m + torch.log(C.sum_over(se, mesh, "model"))
    lo = C.axis_index(mesh, "model") * logits.shape[-1]
    vocab = lo + torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(vocab == lab[..., None], logits, 0.0).sum(-1)
    return logz, C.sum_over(gold, mesh, "model")


def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, remat: bool = True):
    """Token-mean cross entropy (+ 0.01 x the MoE aux loss); labels ==
    -100 masked out. Returns ``(loss, {"xent", "aux"})``, as in JAX; a
    family without MoE has aux 0.

    The gold logit is taken as a masked sum over the vocabulary (one
    nonzero term, so exact) rather than a gather, whose backward on the
    card scatters with atomics: this backward is a ``where``, and two
    runs of a step give the same bits. The vlm's patch prefix is
    stripped before the loss."""
    x, positions, enc_out = embed_inputs(params, batch, cfg)
    x, aux, _ = backbone_full(params, x, cfg, positions=positions,
                              enc_out=enc_out, remat=remat)
    if cfg.family == "vlm":
        x = x[:, batch["patches"].shape[1]:]
    logits = logits_fn(params, x, cfg)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lab = torch.clamp(labels, min=0)
    logz, gold = _xent_parts(logits, lab, _head(params, cfg)[1])
    nll = (logz - gold) * mask
    total, count = torch.sum(nll), torch.sum(mask)
    for ax in L.dp_axes():     # the global batch's mean on every rank
        total = C.sum_over(total, L._ambient_mesh(), ax)
        count = C.sum_over(count, L._ambient_mesh(), ax)
    loss = total / torch.clamp(count, min=1.0)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------

def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, cache_len: int):
    """Run the prompt, return (last-token logits, decode cache).

    The cache is `make_decode_cache`'s in the activations' dtype (the
    SSM states f32): the attention positions' K/V hold the prompt's rows
    and the rest is zero, as JAX pads them; the Mamba positions hold the
    prompt's SSM and conv states; the encdec cache holds the encoder's
    output. The vlm's prompt is its patches and tokens, so ``pos`` and
    the K/V rows count the patches too. Under a mesh the cache is this
    rank's blocks (`_local_cache`), and a cache split over positions
    takes the prompt's rows that fall in the rank's block.
    """
    x, positions, enc_out = embed_inputs(params, batch, cfg)
    S = x.shape[1]
    keep = None
    if L._kv_whole(cfg):
        # K/V whole on every rank, the cache split over positions: each
        # period keeps only the prompt's rows in this rank's block
        n = cache_len // L._size("model")
        lo = C.axis_index(L._ambient_mesh(), "model") * n
        rows = slice(lo, lo + max(0, min(S - lo, n)))

        def keep(period):
            return {t: dict(e, kv=tuple(x[:, rows].clone() for x in e["kv"]))
                    if "kv" in e else e for t, e in period.items()}
    x, _, caches = backbone_full(params, x, cfg, positions=positions,
                                 enc_out=enc_out, want_cache=True,
                                 remat=False, keep=keep)
    logits = logits_fn(params, x[:, -1:], cfg)
    cache = _local_cache(cfg, x.shape[0], cache_len, x.dtype, x.device)
    cache["pos"].fill_(S)
    for t, c in caches.items():
        ent = cache["blocks"][t]
        if "kv" in c:
            k_, v_ = c["kv"]   # (n_periods, B, S or this rank's rows, KV, Dh)
            ent["k"][:, :, :k_.shape[2]] = k_
            ent["v"][:, :, :v_.shape[2]] = v_
        if "ssm" in c:
            ent["ssm"].copy_(c["ssm"]["ssm"])
            for part in ("x", "bc"):
                ent["conv"][part].copy_(c["ssm"]["conv"][part])
    if enc_out is not None:
        cache["enc_out"].copy_(enc_out)
    return logits, cache


def _local_cache(cfg: ModelConfig, batch: int, cache_len: int,
                 dtype: torch.dtype, device) -> Dict[str, Any]:
    """`make_decode_cache` of ``batch`` rows (this rank's), or under a
    mesh this rank's blocks of the global cache as
    `sharding.cache_specs` lays it out (the global batch is ``batch``
    times the data ranks where the rows are split)."""
    amb = L.ambient()
    if amb is None:
        return make_decode_cache(cfg, batch=batch, cache_len=cache_len,
                                 dtype=dtype, device=device)
    from repro_torch.models import sharding as SH
    mesh = amb.mesh
    rows = batch * (L._dp_total() if L._rows_split() else 1)
    meta = make_decode_cache(cfg, batch=rows, cache_len=cache_len,
                             dtype=dtype, device="meta")
    return SH.tree_map_with_path(
        lambda _, t, spec: torch.zeros(SH.block_shape(t.shape, spec, mesh),
                                       dtype=t.dtype, device=device),
        meta, SH.cache_specs(cfg, mesh, meta))


def make_decode_cache(cfg: ModelConfig, *, batch: int, cache_len: int,
                      dtype: torch.dtype, device="cuda") -> Dict[str, Any]:
    """Zero-initialised cache: ``{"pos": 0-d int32, "blocks": {t: ...}}``,
    JAX's shapes and dtypes. An attention position holds ``"k"``/``"v"``
    of (n_periods, batch, cache_len, KV, Dh) in ``dtype``; a Mamba
    position ``"ssm"`` (n_periods, batch, nh, head_dim, d_state) in f32
    and ``"conv": {"x", "bc"}``, the last d_conv - 1 inputs of its convs,
    in ``dtype``. The encdec cache also holds ``"enc_out"`` (batch,
    n_ctx, d_model) in ``dtype``."""
    device = resolve_device(device)
    np_ = n_periods(cfg)

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    blocks = {}
    for t in range(period_len(cfg)):
        if pos_is_attn(cfg, t):
            shp = (np_, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
            blocks[str(t)] = {"k": zeros(*shp), "v": zeros(*shp)}
        else:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            nh = d_in // s.head_dim
            gn = s.n_groups * s.d_state
            blocks[str(t)] = {
                "ssm": zeros(np_, batch, nh, s.head_dim, s.d_state,
                             dt=torch.float32),
                "conv": {"x": zeros(np_, batch, s.d_conv - 1, d_in),
                         "bc": zeros(np_, batch, s.d_conv - 1, 2 * gn)}}
    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device),
             "blocks": blocks}
    if cfg.family == "encdec":
        cache["enc_out"] = zeros(batch, cfg.encoder.n_ctx, cfg.d_model)
    return cache


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig):
    """One decode step. token: (B, 1) int. Returns (logits, new cache).

    The cache is donated, as JAX's decode step donates it: its K/V rows,
    SSM states and conv states are written into its tensors in place and
    belong to the returned cache, whose ``pos`` is a new tensor one
    higher. Do not reuse the old one. The encdec decoder adds the
    sinusoid's row at ``pos`` and attends to the cache's ``enc_out``.
    Under a mesh the cache is this rank's blocks (`prefill`'s) and each
    period's weights are gathered as it runs.
    """
    table, sharded = _top(params, "embed")
    x = _embed(table, token, sharded)
    pos = cache["pos"]
    if cfg.family == "encdec":
        x = x + sinusoid_at(pos, cfg.d_model, x.dtype)[None, None]
    enc_out = cache.get("enc_out")
    blocks = cache["blocks"]
    for i, pp in enumerate(_periods(params["blocks"], n_periods(cfg))):
        pp = L.gathered(pp, "blocks", stacked=True)
        for t in range(period_len(cfg)):
            p, ent = pp[str(t)], blocks[str(t)]
            h_in = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            if pos_is_attn(cfg, t):
                h, _ = L.attention_decode_fwd(
                    p["attn"], h_in, cfg, k_cache=ent["k"][i],
                    v_cache=ent["v"][i], pos=pos,
                    use_rope=cfg.family != "encdec")
            else:
                conv = ent["conv"]
                h, st = L.mamba_decode_fwd(
                    p["mamba"], h_in, cfg.ssm, cfg.d_model,
                    {"ssm": ent["ssm"][i],
                     "conv": {"x": conv["x"][i], "bc": conv["bc"][i]}})
                ent["ssm"][i].copy_(st["ssm"])
                conv["x"][i].copy_(st["conv"]["x"])
                conv["bc"][i].copy_(st["conv"]["bc"])
            x = x + h
            if cfg.family == "encdec":
                x = x + _cross(p, x, enc_out, cfg)
            x, _ = _ffn(p, x, cfg, t)
    logits = logits_fn(params, x, cfg)
    return logits, dict(cache, pos=pos + 1)

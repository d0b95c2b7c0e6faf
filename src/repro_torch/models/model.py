"""The decoder of the model zoo, dense family: init, training loss,
prefill and decode.

Port of `repro/models/model.py` for ``family="dense"``. Layers are stacked
per *period position*, with a leading ``n_periods`` dimension, as in JAX,
so a JAX parameter tree maps onto the port's one to one
(`repro_torch.convert.params_from_numpy`). JAX scans the stack; the port
loops over the periods, each a slice of one `torch.unbind` of the stack
(so a backward pass stacks the periods' gradients once).

  family    period   position structure
  dense      1       [attn + mlp]

``backbone_full(..., remat=True)`` (training) runs each period under
`torch.utils.checkpoint.checkpoint` (non-reentrant): its activations are
recomputed in the backward pass instead of kept. JAX's remat policy
(``dots_with_no_batch_dims_saveable``) only chooses what is kept, so
remat on and off give the same bits. Serving runs without it.

The other families (moe, ssm, hybrid, encdec, vlm) are refused with a
`NotImplementedError` where parameters, caches or a forward pass are
built (ROADMAP Queue 1 item 10); nothing is computed half-way.

Entry points: init_params / train_loss / prefill / make_decode_cache /
decode_step.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels._build import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]

#: the families the port's model runs
PORTED_FAMILIES = ("dense",)


def require_ported(family: str) -> None:
    """Raise for a model family the port does not run yet."""
    if family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the port runs the dense family only; family={family!r} "
            f"waits for ROADMAP Queue 1 item 10")


# --------------------------------------------------------------------------
# period structure
# --------------------------------------------------------------------------

def n_periods(cfg: ModelConfig) -> int:
    """The length of the stack: the dense family's period is one layer."""
    return cfg.n_layers


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_position(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Params for one dense layer."""
    d = cfg.d_model
    ones = torch.ones((d,), dtype=L.PDTYPE, device=gen.device)
    return {"ln1": ones, "attn": L.init_attention(gen, cfg),
            "ln2": ones.clone(), "mlp": L.init_mlp(gen, d, cfg.d_ff)}


def _stack(trees):
    """Leaf-wise `torch.stack` of equally shaped param trees."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _init_stacked(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Params]:
    """{pos_t: params stacked over periods}: the dense family's period is
    one layer, keyed "0" as in JAX."""
    return {"0": _stack([_init_position(gen, cfg)
                         for _ in range(n_periods(cfg))])}


def init_params(seed: int, cfg: ModelConfig, device="cuda") -> Params:
    """Random weights from ``seed`` on ``device``: the JAX package's tree
    and distributions (N(0, 1) scaled by fan-in^-0.5, bf16), drawn from
    one `torch.Generator` on the device (so not JAX's numbers)."""
    require_ported(cfg.family)
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
# forward: full-sequence (train / prefill)
# --------------------------------------------------------------------------

def _layer_full(p: Params, x, cfg: ModelConfig, *, positions):
    """One dense layer, full sequence. Returns (x, (k, v))."""
    h, kv = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, positions=positions)
    x = x + h
    x = x + L.mlp_fwd(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, kv


def backbone_full(params: Params, x, cfg: ModelConfig, *, positions,
                  want_cache: bool = False, remat: bool = True):
    """Run the stacked blocks over a full sequence, period by period.
    Returns (x, caches): with ``want_cache``, ``caches[t]["kv"]`` is the
    (k, v) of every period stacked, (n_periods, B, S, KV, Dh) each.
    ``remat`` recomputes each period's activations in the backward pass
    (it changes no value)."""
    require_ported(cfg.family)
    ks, vs = [], []
    for p in _periods(params["blocks"]["0"], n_periods(cfg)):
        if remat:
            x, (k_, v_) = checkpoint(_layer_full, p, x, cfg,
                                     positions=positions,
                                     use_reentrant=False)
        else:
            x, (k_, v_) = _layer_full(p, x, cfg, positions=positions)
        if want_cache:
            ks.append(k_)
            vs.append(v_)
    caches = {"0": {"kv": (torch.stack(ks), torch.stack(vs))}} \
        if want_cache else {}
    return x, caches


def embed_inputs(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig):
    """tokens -> (x, positions). The activations take the parameters'
    dtype: bf16, JAX's ``PDTYPE`` and ``CDTYPE``; f32 for upcast weights."""
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    positions = torch.arange(x.shape[1], device=x.device)[None]
    return x, positions


def logits_fn(params: Params, x, cfg: ModelConfig):
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ w).float()


def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, *, remat: bool = True):
    """Token-mean cross entropy; labels == -100 masked out. Returns
    ``(loss, {"xent", "aux"})``; the dense family has no auxiliary loss,
    so aux is 0 and the loss is the cross entropy, as in JAX.

    The gold logit is taken as a masked sum over the vocabulary (one
    nonzero term, so exact) rather than a gather, whose backward on the
    card scatters with atomics: this backward is a ``where``, and two
    runs of a step give the same bits."""
    require_ported(cfg.family)
    x, positions = embed_inputs(params, batch, cfg)
    x, _ = backbone_full(params, x, cfg, positions=positions, remat=remat)
    logits = logits_fn(params, x, cfg)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lab = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(vocab == lab[..., None], logits, 0.0).sum(-1)
    nll = (logz - gold) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    aux = torch.zeros((), device=loss.device)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------

def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            *, cache_len: int):
    """Run the prompt, return (last-token logits, decode cache).

    The K/V caches are allocated at ``cache_len``, in the dtype of the
    prompt's K/V, and hold the prompt's rows; the rest is zero, as JAX
    pads them.
    """
    require_ported(cfg.family)
    x, positions = embed_inputs(params, batch, cfg)
    S = x.shape[1]
    x, caches = backbone_full(params, x, cfg, positions=positions,
                              want_cache=True, remat=False)
    logits = logits_fn(params, x[:, -1:], cfg)
    cache = make_decode_cache(cfg, batch=x.shape[0], cache_len=cache_len,
                              dtype=caches["0"]["kv"][0].dtype,
                              device=x.device)
    cache["pos"].fill_(S)
    k_, v_ = caches["0"]["kv"]   # (n_periods, B, S, KV, Dh)
    cache["blocks"]["0"]["k"][:, :, :S] = k_
    cache["blocks"]["0"]["v"][:, :, :S] = v_
    return logits, cache


def make_decode_cache(cfg: ModelConfig, *, batch: int, cache_len: int,
                      dtype: torch.dtype, device="cuda") -> Dict[str, Any]:
    """Zero-initialised cache: ``{"pos": 0-d int32, "blocks": {"0": {"k",
    "v"}}}`` with (n_periods, batch, cache_len, KV, Dh) K/V."""
    require_ported(cfg.family)
    device = resolve_device(device)
    shp = (n_periods(cfg), batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "blocks": {"0": {"k": torch.zeros(shp, dtype=dtype,
                                              device=device),
                             "v": torch.zeros(shp, dtype=dtype,
                                              device=device)}}}


def decode_step(params: Params, token: torch.Tensor, cache: Dict[str, Any],
                cfg: ModelConfig):
    """One decode step. token: (B, 1) int. Returns (logits, new cache).

    The cache is donated, as JAX's decode step donates it: its K/V
    tensors take the new rows in place and belong to the returned cache,
    whose ``pos`` is a new tensor one higher. Do not reuse the old one.
    """
    require_ported(cfg.family)
    x = params["embed"][token]
    pos = cache["pos"]
    ent = cache["blocks"]["0"]
    for i, p in enumerate(_periods(params["blocks"]["0"], n_periods(cfg))):
        h, _ = L.attention_decode_fwd(
            p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
            k_cache=ent["k"][i], v_cache=ent["v"][i], pos=pos)
        x = x + h
        x = x + L.mlp_fwd(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
    logits = logits_fn(params, x, cfg)
    return logits, dict(cache, pos=pos + 1)

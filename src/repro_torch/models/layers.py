"""Model building blocks: norms, RoPE, attention, MLP, MoE, Mamba2 SSD.

Port of `repro/models/layers.py`. Everything is functional: ``init_*``
returns a params dict of tensors, ``*_fwd`` maps (params, activations)
-> activations.
Params are stored bf16 (the MoE router and the SSD's ``A_log``, ``D``
and ``dt_bias`` f32, as in JAX) and activations run in the params'
dtype (bf16; f32 for upcast weights), which plays JAX's ``CDTYPE``;
norms, RoPE, the softmax, the router and the SSD's decays run in f32,
as in JAX.

The JAX package takes the attention scores and ``p . v``, the experts'
products and the SSD's from bf16 operands with
``preferred_element_type=float32``. A bf16 matmul in torch rounds its
result to bf16, so these products are taken here as f32 products of
bf16-rounded operands (`_f32_of`), which keeps the f32 bits of the sum.
They run as true f32 only while TF32 is off
(``torch.backends.cuda.matmul.allow_tf32``, off by default, which the
port keeps). The projections (``x @ wq``, the MLP, the SSD's in and out
projections) are bf16 x bf16 -> bf16 in JAX and stay bf16 matmuls here.

Attention comes in three entry points:
  * ``flash_attention``   prefill: two-level chunked running-max softmax
                          (q chunks over kv chunks), the JAX tiling.
  * ``decode_attention``  one new token against a (B, S, KV, Dh) cache.
  * ``cross_attention_fwd``  enc-dec (whisper): full (non-causal)
                          attention against the encoder's K/V
                          (``cross_kv``).

JAX's ``constrain``, ``_ambient_mesh`` and ``_seqpar_flash`` only lay
arrays out over a device mesh; one card has no counterpart to them.
Without a mesh JAX's `moe_fwd` runs its single-device dispatch
(``_moe_fwd_dense``), and so does the port's; the expert-parallel
dispatch (``_moe_fwd_ep``) waits for the sharded train step (ROADMAP
Queue 1 item 10, step 5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

Params = Dict[str, Any]
PDTYPE = torch.bfloat16   # parameter storage dtype
CDTYPE = torch.bfloat16   # compute dtype of the attention's operands


def _f32_of(x: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the compute dtype ``cdtype``, as f32: an operand
    of the f32 products that JAX takes with
    ``preferred_element_type=float32``."""
    return x.to(cdtype).float()


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None, dtype=PDTYPE) -> torch.Tensor:
    """N(0, 1) * ``scale`` (default d_in^-0.5) drawn in f32 from ``gen``
    on its device, stored as ``dtype``."""
    scale = scale if scale is not None else d_in ** -0.5
    return (torch.randn(d_in, d_out, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                    # (Dh/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    p = {
        "wq": dense_init(gen, d, cfg.q_dim()),
        "wk": dense_init(gen, d, cfg.kv_dim()),
        "wv": dense_init(gen, d, cfg.kv_dim()),
        "wo": dense_init(gen, cfg.q_dim(), d),
    }
    if cfg.attn_bias:
        for name, n in (("bq", cfg.q_dim()), ("bk", cfg.kv_dim()),
                        ("bv", cfg.kv_dim())):
            p[name] = torch.zeros((n,), dtype=PDTYPE, device=gen.device)
    return p


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[0], x.shape[1]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _pick_chunk(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (chunked-attention tiling)."""
    c = min(S, target)
    while S % c:
        c -= 1
    return c


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_chunk: int = 512, kv_chunk: int = 1024,
                    q_offset: int = 0, cdtype: torch.dtype = CDTYPE
                    ) -> torch.Tensor:
    """Chunked attention with running-max softmax (flash pattern).

    q: (B, Sq, H, Dh); k/v: (B, Skv, KV, Dh) with H a multiple of KV (GQA).
    Peak score memory is q_chunk x kv_chunk per (batch, head).
    ``q_offset``: global position of q's first row. The products' operands
    are rounded to ``cdtype`` (JAX's ``CDTYPE``).
    """
    B, Sq, H, Dh = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_chunk = _pick_chunk(Sq, q_chunk)
    kv_chunk = _pick_chunk(Skv, kv_chunk)
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    scale = Dh ** -0.5
    dev = q.device

    qc = _f32_of(q, cdtype).reshape(B, nq, q_chunk, KV, G, Dh)
    kc = _f32_of(k, cdtype).reshape(B, nk, kv_chunk, KV, Dh)
    vc = _f32_of(v, cdtype).reshape(B, nk, kv_chunk, KV, Dh)
    outs = []
    for qi in range(nq):
        qx = qc[:, qi]                       # (B, q_chunk, KV, G, Dh)
        m = torch.full((B, KV, G, q_chunk), -math.inf, device=dev)
        l_ = torch.zeros((B, KV, G, q_chunk), device=dev)
        acc = torch.zeros((B, KV, G, q_chunk, Dh), device=dev)
        for ki in range(nk):
            kx, vx = kc[:, ki], vc[:, ki]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qx, kx) * scale
            if causal:
                qpos = (q_offset + qi * q_chunk
                        + torch.arange(q_chunk, device=dev))
                kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            # guard fully-masked rows (m == -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p_ = torch.exp(s - m_safe[..., None])
            p_ = torch.where(torch.isfinite(s), p_, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                0.0)
            l_ = l_ * alpha + torch.sum(p_, dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", _f32_of(p_, cdtype), vx)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l_[..., None], min=1e-30)
        # (B, KV, G, q_chunk, Dh) -> (B, q_chunk, KV, G, Dh)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dh)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos, *,
                     cdtype: torch.dtype = CDTYPE) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B, 1, H, Dh); caches: (B, S, KV, Dh); pos: the current length (a
    0-d tensor or an int); cache rows past it are masked. The products'
    operands are rounded to ``cdtype``.
    """
    B, _, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = Dh ** -0.5
    qh = _f32_of(q, cdtype).reshape(B, KV, G, Dh)
    s = torch.einsum("bhgd,bshd->bhgs", qh, _f32_of(k_cache, cdtype)) * scale
    mask = torch.arange(S, device=q.device)[None, None, None, :] <= pos
    s = torch.where(mask, s, -math.inf)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", _f32_of(p, cdtype),
                       _f32_of(v_cache, cdtype))
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def attention_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, causal: bool = True,
                  use_rope: bool = True):
    """Full-sequence attention (train / prefill) in ``x``'s dtype, the
    compute dtype: causal, with RoPE, by default; the whisper encoder
    runs it bidirectional and without RoPE, its decoder without RoPE.
    Returns (out, (k, v))."""
    q, k, v = _qkv(p, x, cfg)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, cdtype=x.dtype)
    B, S = x.shape[0], x.shape[1]
    return o.reshape(B, S, cfg.q_dim()) @ p["wo"], (k, v)


def attention_decode_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos: torch.Tensor, use_rope: bool = True):
    """One-token attention step in ``x``'s dtype. x: (B, 1, D); pos: 0-d
    int tensor.

    The new K/V rows are written into ``k_cache``/``v_cache`` at ``pos``
    in place (JAX donates the cache and updates a slice: the same
    semantics, no copy of the cache). Returns (out, (k_cache, v_cache)).
    """
    q, k, v = _qkv(p, x, cfg)
    if use_rope:
        ppos = pos.reshape(1, 1).expand(x.shape[0], 1)
        q = apply_rope(q, ppos, cfg.rope_theta)
        k = apply_rope(k, ppos, cfg.rope_theta)
    at = pos.reshape(1).long()
    k_cache.index_copy_(1, at, k.to(k_cache.dtype))
    v_cache.index_copy_(1, at, v.to(v_cache.dtype))
    o = decode_attention(q, k_cache, v_cache, pos, cdtype=x.dtype)
    out = o.reshape(x.shape[0], 1, cfg.q_dim()) @ p["wo"]
    return out, (k_cache, v_cache)


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return init_attention(gen, dataclasses.replace(cfg, attn_bias=False))


def cross_attention_fwd(p: Params, x: torch.Tensor,
                        enc_kv: Tuple[torch.Tensor, torch.Tensor],
                        cfg: ModelConfig) -> torch.Tensor:
    """Decoder-side cross attention against precomputed encoder K/V, in
    ``x``'s dtype."""
    B, S = x.shape[0], x.shape[1]
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k, v = enc_kv
    o = flash_attention(q, k, v, causal=False, cdtype=x.dtype)
    return o.reshape(B, S, cfg.q_dim()) @ p["wo"]


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder's K/V for the cross attention: (B, S_enc, KV, Dh)
    each."""
    B, S = enc_out.shape[0], enc_out.shape[1]
    k = (enc_out @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return k, v


# --------------------------------------------------------------------------
# dense MLP (SwiGLU)
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int) -> Params:
    return {"w_gate": dense_init(gen, d, f),
            "w_up": dense_init(gen, d, f),
            "w_down": dense_init(gen, f, d)}


def mlp_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = F.silu((x @ p["w_gate"]).float()).to(x.dtype)
    h = g * (x @ p["w_up"])
    return h @ p["w_down"]


# --------------------------------------------------------------------------
# MoE (top-k router, capacity dispatch)
# --------------------------------------------------------------------------

def init_moe(gen: torch.Generator, d: int, moe: MoEConfig) -> Params:
    """An f32 router (d, E) and bf16 expert stacks: ``w_gate``/``w_up``
    (E, d, F), ``w_down`` (E, F, d), each N(0, 1) * fan-in^-0.5."""
    e, f = moe.n_experts, moe.d_expert_ff

    def estack(din, dout):
        return (torch.randn(e, din, dout, generator=gen, dtype=torch.float32,
                            device=gen.device) * din ** -0.5).to(PDTYPE)

    return {"router": dense_init(gen, d, e, dtype=torch.float32),
            "w_gate": estack(d, f),
            "w_up": estack(d, f),
            "w_down": estack(f, d)}


def moe_route(p: Params, xt: torch.Tensor, moe: MoEConfig):
    """The router of `moe_fwd` over xt (T, D): ``(probs, top_p, top_e,
    valid, slot, cap)``. ``top_p`` is the top-k probabilities
    renormalised; each (token, choice) takes a rank within its expert in
    token-major order (an exclusive cumsum of the one-hot) and is kept
    (``valid``) while its rank is below the capacity ``cap = int(cf * T *
    K / E + 0.999)``; ``slot`` is ``expert * cap + rank`` where kept and
    ``E * cap`` where dropped."""
    T = xt.shape[0]
    E, K = moe.n_experts, moe.top_k
    cap = int(moe.capacity_factor * T * K / E + 0.999)
    logits = xt.float() @ p["router"]                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)                # (T, K)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    flat_e = top_e.reshape(T * K)
    onehot = F.one_hot(flat_e, E)                              # (T*K, E)
    rank = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=-1)
    valid = rank < cap
    slot = torch.where(valid, flat_e * cap + rank, E * cap)
    return probs, top_p, top_e, valid, slot, cap


def moe_fwd(p: Params, x: torch.Tensor, moe: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE, JAX's single-device (GShard-style,
    sort-free) dispatch. x: (B, S, D) -> (out in x's dtype, f32 aux).

    The kept (token, choice) rows (`moe_route`) are written at their
    unique slots of an (E * cap, D) buffer (an ``index_put`` with no
    accumulation, whose backward is a gather); the dropped ones are
    written as zeros into one extra row, ``E * cap``, which the combine's
    gather reads for them (weight 0), so the gather's backward adds
    exactly one term into every real slot. Two runs give the same bits
    on the card. The aux loss is Switch's: ``E * sum(mean(probs) *
    mean(onehot(top-1 expert)))``.
    """
    B, S, D = x.shape
    T = B * S
    E, K = moe.n_experts, moe.top_k
    xt = x.reshape(T, D)
    probs, top_p, top_e, valid, slot, cap = moe_route(p, xt, moe)

    x_rep = torch.repeat_interleave(xt, K, dim=0)              # (T*K, D)
    w = torch.where(valid, top_p.reshape(T * K), 0.0)
    buf = torch.zeros((E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot,), torch.where(valid[:, None], x_rep, 0.0))
    buf = buf[:E * cap].reshape(E, cap, D)

    bf = buf.float()
    g = F.silu(torch.bmm(bf, p["w_gate"].float()))
    u = torch.bmm(bf, p["w_up"].float())
    y = torch.bmm((g * u).to(x.dtype).float(), p["w_down"].float())
    y = torch.cat([y.reshape(E * cap, D), y.new_zeros((1, D))])

    y_tok = y[slot]                                            # (T*K, D)
    out = torch.sum((y_tok * w[:, None]).reshape(T, K, D), dim=1)

    # load-balance auxiliary loss (Switch-style)
    me = torch.mean(probs, dim=0)                              # (E,)
    ce = torch.mean(F.one_hot(top_e[:, 0], E).float(), dim=0)
    aux = E * torch.sum(me * ce)
    return out.reshape(B, S, D).to(x.dtype), aux


# --------------------------------------------------------------------------
# Mamba2 (SSD: state-space duality, chunked scan)
# --------------------------------------------------------------------------

def init_mamba(gen: torch.Generator, d: int, ssm: SSMConfig) -> Params:
    """Mamba2 block params, the input projection stored per component
    (z, x, B, C, dt) as in JAX. ``A_log``, ``D`` and ``dt_bias`` are f32;
    the rest bf16."""
    d_in = ssm.expand * d
    nh = d_in // ssm.head_dim
    gn = ssm.n_groups * ssm.d_state
    dev = gen.device

    def conv(c):
        return (torch.randn(ssm.d_conv, c, generator=gen, dtype=torch.float32,
                            device=dev) * 0.1).to(PDTYPE)

    return {
        "wz": dense_init(gen, d, d_in),
        "wx": dense_init(gen, d, d_in),
        "wB": dense_init(gen, d, gn),
        "wC": dense_init(gen, d, gn),
        "wdt": dense_init(gen, d, nh),
        "conv_x": conv(d_in),
        "conv_bc": conv(2 * gn),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm": torch.ones((d_in,), dtype=PDTYPE, device=dev),
        "out_proj": dense_init(gen, d_in, d),
    }


def _silu_as(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """silu in f32, rounded to ``dtype`` (JAX's
    ``jax.nn.silu(x.astype(float32)).astype(dtype)``)."""
    return F.silu(x.float()).to(dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor]):
    """Depthwise causal conv, width d_conv. x: (B, L, C); w: (d_conv, C).

    Returns (silu(y), new_state), the state the trailing (d_conv - 1)
    inputs. The ``d_conv`` products are added left to right in x's dtype,
    as JAX's Python ``sum`` adds them."""
    dconv, L = w.shape[0], x.shape[1]
    if state is None:
        state = torch.zeros((x.shape[0], dconv - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = xp[:, 0:L] * w[0]
    for i in range(1, dconv):
        y = y + xp[:, i:i + L] * w[i]
    return _silu_as(y, x.dtype), xp[:, -(dconv - 1):]


def _ssd_proj(p: Params, u: torch.Tensor, ssm: SSMConfig, d: int,
              conv_state: Optional[Dict[str, torch.Tensor]]):
    """Project u -> (z, x, B, C, dt) and run the causal convs."""
    d_in = ssm.expand * d
    nh = d_in // ssm.head_dim
    gn = ssm.n_groups * ssm.d_state
    z = u @ p["wz"]
    xr = u @ p["wx"]
    bc = torch.cat([u @ p["wB"], u @ p["wC"]], dim=-1)
    dt = u @ p["wdt"]
    cs_x = None if conv_state is None else conv_state["x"]
    cs_bc = None if conv_state is None else conv_state["bc"]
    xr, ns_x = _causal_conv(xr, p["conv_x"], cs_x)
    bc, ns_bc = _causal_conv(bc, p["conv_bc"], cs_bc)
    Bm, Cm = torch.chunk(bc, 2, dim=-1)
    return z, xr, Bm, Cm, dt, d_in, nh, gn, {"x": ns_x, "bc": ns_bc}


def _gated_out(p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``rms_norm(y * silu(z))`` in y's dtype (JAX's gated norm)."""
    return rms_norm(y * _silu_as(z, y.dtype), p["norm"], 1e-5)


def mamba_fwd(p: Params, u: torch.Tensor, ssm: SSMConfig, d: int, *,
              init_state=None, return_state: bool = False):
    """Chunked SSD forward. u: (B, L, D).

    A loop over the ``L / Q`` chunks (Q = min(chunk, L); L front-padded
    to a multiple of Q): within a chunk the quadratic (Q x Q) dual form,
    across chunks an f32 (B, nh, hd, N) state carries the recurrence.
    The products round their operands where JAX does: the scores, C and
    the carried state to the compute dtype (u's), the intra-chunk decays
    stay f32.

    The decay matrix is ``exp(where(causal, seg_q - seg_s, -inf))``: the
    same values as JAX's ``where(causal, exp(seg_q - seg_s), 0)``, but
    the exponent above the diagonal (a positive sum of up to Q - 1 step
    sizes, which passes f32's range after ~110 positions) is never taken,
    so the gradient stays finite where JAX's is NaN (ROADMAP Queue 3
    item 9).
    """
    B, L, _ = u.shape
    Q = min(ssm.chunk, L)
    pad = -L % Q
    if pad:
        assert init_state is None, "chunk-pad + carried state unsupported"
        # FRONT-pad to a chunk multiple: zero inputs contribute nothing to
        # states or outputs, and the initial state is zero
        u = F.pad(u, (0, 0, pad, 0))
        L = L + pad
    nc = L // Q
    conv_state = None if init_state is None else init_state["conv"]
    z, xs, Bm, Cm, dt, d_in, nh, gn, conv_out_state = \
        _ssd_proj(p, u, ssm, d, conv_state)
    hd, N, G = ssm.head_dim, ssm.d_state, ssm.n_groups
    cd = u.dtype
    hpg = nh // G

    xh = xs.reshape(B, nc, Q, nh, hd)
    Bh = Bm.reshape(B, nc, Q, G, N)
    Ch = Cm.reshape(B, nc, Q, G, N)
    dt = _softplus(dt.float() + p["dt_bias"]).reshape(B, nc, Q, nh)
    A = -torch.exp(p["A_log"])                                 # (nh,)
    dA = dt * A
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=u.device))[None, :, :, None]

    state = (torch.zeros((B, nh, hd, N), dtype=torch.float32,
                         device=u.device) if init_state is None
             else init_state["ssm"])
    ys = []
    for c in range(nc):
        xq, dtq, dAq = xh[:, c], dt[:, c], dA[:, c]
        seg = torch.cumsum(dAq, dim=1)                         # (B,Q,nh)
        tot = seg[:, -1:]                                      # (B,1,nh)
        # intra-chunk dual form
        Bg = torch.repeat_interleave(Bh[:, c], hpg, dim=2)     # (B,Q,nh,N)
        Cg = torch.repeat_interleave(Ch[:, c], hpg, dim=2)
        diff = seg[:, :, None, :] - seg[:, None, :, :]         # (B,Q,Q,nh)
        Lmat = torch.exp(torch.where(causal, diff, -math.inf))
        scores = torch.einsum("bqhn,bshn->bqsh", Cg.float(), Bg.float())
        scores = scores * Lmat * dtq[:, None, :, :]
        y_intra = torch.einsum("bqsh,bshp->bqhp", _f32_of(scores, cd),
                               xq.float())
        # inter-chunk: contribution of the carried state
        y_inter = torch.einsum("bqhn,bhpn->bqhp", _f32_of(Cg, cd),
                               _f32_of(state, cd))
        y_inter = y_inter * torch.exp(seg)[..., None]
        # new chunk state
        decay_in = torch.exp(tot - seg) * dtq                  # (B,Q,nh)
        st_local = torch.einsum("bqhp,bqhn->bhpn",
                                xq.float() * decay_in[..., None], Bg.float())
        state = state * torch.exp(tot)[:, 0, :, None, None] + st_local
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(B, L, nh, hd)
    y = y + xh.reshape(B, L, nh, hd).float() * p["D"][None, None, :, None]
    y = _gated_out(p, y.reshape(B, L, d_in).to(cd), z)
    if pad:
        y = y[:, pad:]
    out = y @ p["out_proj"]
    if return_state:
        return out, {"ssm": state, "conv": conv_out_state}
    return out


def mamba_decode_fwd(p: Params, u: torch.Tensor, ssm: SSMConfig, d: int,
                     state: Dict[str, Any]):
    """Single-token SSM step. u: (B, 1, D); state: {ssm, conv: {x, bc}}.
    Returns (out, new state), the state in new tensors."""
    B = u.shape[0]
    z, xs, Bm, Cm, dt, d_in, nh, gn, conv_state = \
        _ssd_proj(p, u, ssm, d, state["conv"])
    hd, N, G = ssm.head_dim, ssm.d_state, ssm.n_groups
    hpg = nh // G
    xh = xs.reshape(B, nh, hd).float()
    Bh = torch.repeat_interleave(Bm.reshape(B, G, N), hpg, dim=1).float()
    Ch = torch.repeat_interleave(Cm.reshape(B, G, N), hpg, dim=1).float()
    dtv = _softplus(dt.float() + p["dt_bias"]).reshape(B, nh)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtv * A[None, :])                        # (B,nh)
    st = state["ssm"] * decay[:, :, None, None] \
        + torch.einsum("bhp,bhn->bhpn", xh * dtv[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", st, Ch) + xh * p["D"][None, :, None]
    y = _gated_out(p, y.reshape(B, 1, d_in).to(u.dtype), z)
    return y @ p["out_proj"], {"ssm": st, "conv": conv_state}

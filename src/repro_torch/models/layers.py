"""Model building blocks of the dense family: norms, RoPE, attention, MLP.

Port of the dense subset of `repro/models/layers.py`. Everything is
functional: ``init_*`` returns a params dict of tensors, ``*_fwd`` maps
(params, activations) -> activations. Params are stored bf16 and
activations run in the params' dtype (bf16; f32 for upcast weights);
norms, RoPE, the softmax and the attention products run in f32, as in
JAX.

The JAX package takes the attention scores and ``p . v`` from bf16
operands with ``preferred_element_type=float32``. A bf16 matmul in torch
rounds its result to bf16, so these products are taken here as f32
products of bf16-rounded operands (`_f32_of`), which keeps the f32 bits
of the sum. They run as true f32 only while TF32 is off
(``torch.backends.cuda.matmul.allow_tf32``, off by default, which the
port keeps). The projections (``x @ wq``, the MLP) are bf16 x bf16 ->
bf16 in JAX and stay bf16 matmuls here.

Attention comes in two entry points:
  * ``flash_attention``   prefill: two-level chunked running-max softmax
                          (q chunks over kv chunks), the JAX tiling.
  * ``decode_attention``  one new token against a (B, S, KV, Dh) cache.

JAX's ``constrain``, ``_ambient_mesh`` and ``_seqpar_flash`` only lay
arrays out over a device mesh; one card has no counterpart to them.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

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
                  positions: torch.Tensor):
    """Full-sequence causal attention (prefill) in ``x``'s dtype, the
    compute dtype. Returns (out, (k, v))."""
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True, cdtype=x.dtype)
    B, S = x.shape[0], x.shape[1]
    return o.reshape(B, S, cfg.q_dim()) @ p["wo"], (k, v)


def attention_decode_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos: torch.Tensor):
    """One-token attention step in ``x``'s dtype. x: (B, 1, D); pos: 0-d
    int tensor.

    The new K/V rows are written into ``k_cache``/``v_cache`` at ``pos``
    in place (JAX donates the cache and updates a slice: the same
    semantics, no copy of the cache). Returns (out, (k_cache, v_cache)).
    """
    q, k, v = _qkv(p, x, cfg)
    ppos = pos.reshape(1, 1).expand(x.shape[0], 1)
    q = apply_rope(q, ppos, cfg.rope_theta)
    k = apply_rope(k, ppos, cfg.rope_theta)
    at = pos.reshape(1).long()
    k_cache.index_copy_(1, at, k.to(k_cache.dtype))
    v_cache.index_copy_(1, at, v.to(v_cache.dtype))
    o = decode_attention(q, k_cache, v_cache, pos, cdtype=x.dtype)
    out = o.reshape(x.shape[0], 1, cfg.q_dim()) @ p["wo"]
    return out, (k_cache, v_cache)


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

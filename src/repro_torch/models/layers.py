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

Under a device mesh (`use_mesh`, JAX's ``jax.set_mesh``) the same
layers run sharded, one rank a process: each rank holds its block of
every weight as `repro_torch.models.sharding.param_specs` lays it out,
`gathered` all-gathers the FSDP dim of a period's weights as it runs,
and the activations are the rank's blocks in the layout JAX's
`constrain` calls name. Where a layer's heads, features or experts
divide the "model" dim it computes its block of them: the input enters
through `collectives.sum_grad_over` (its gradient summed over "model"),
the row-parallel product's share (`Partial`) is summed at the next
constraint, and everything else is computed whole on every rank of
"model", so those ranks hold the same values and gradients. Context
parallelism (`_seqpar_flash`) and the expert-parallel dispatch
(`_moe_fwd_ep`) are JAX's ``shard_map`` bodies, run on each rank's
blocks with the collectives of `repro_torch.core.collectives`. Without a
mesh `constrain` is the identity and every layer runs its single-device
ops.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
from repro_torch.core import collectives as C

Params = Dict[str, Any]
PDTYPE = torch.bfloat16   # parameter storage dtype
CDTYPE = torch.bfloat16   # compute dtype of the attention's operands


def _f32_of(x: torch.Tensor, cdtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the compute dtype ``cdtype``, as f32: an operand
    of the f32 products that JAX takes with
    ``preferred_element_type=float32``."""
    return x.to(cdtype).float()


# --------------------------------------------------------------------------
# the ambient mesh and activation sharding constraints
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Ambient:
    mesh: Any                       # a DeviceMesh
    specs: Dict[str, tuple]         # param path -> its spec
    rows: bool = True               # batch rows split over the data dims


_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_ambient_mesh", default=None)


def ambient() -> Optional[_Ambient]:
    """The mesh (and the params' specs) the layers run under here."""
    return _AMBIENT.get()


@contextlib.contextmanager
def restored(amb: Optional[_Ambient]):
    """Run under ``amb``, an `ambient()` value taken elsewhere: the
    recompute of a checkpointed period in the backward pass runs on
    autograd's thread, which does not see the caller's context."""
    tok = _AMBIENT.set(amb)
    try:
        yield
    finally:
        _AMBIENT.reset(tok)


@contextlib.contextmanager
def use_mesh(mesh, param_specs=None, *, rows_sharded: bool = True):
    """Run the layers under ``mesh`` (a `DeviceMesh` whose dims carry
    JAX's axis names): JAX's ``jax.set_mesh``. ``param_specs`` is the
    params' spec tree (`sharding.param_specs`), by which each rank holds
    its blocks; a JAX array carries its sharding, a torch tensor does
    not, so the layout rides here. Without it the params are whole on
    every rank. ``rows_sharded``: each rank's activations are its share
    of the batch rows over the data dims (`sharding.batch_specs` where the
    global batch divides over them), else the whole batch on every rank.
    ``mesh=None`` is the single-device run."""
    from repro_torch.models.sharding import _path_str, tree_map_with_path
    specs: Dict[str, tuple] = {}
    if param_specs is not None:
        tree_map_with_path(
            lambda path, spec: specs.__setitem__(_path_str(path), spec),
            param_specs)
    with restored(None if mesh is None
                  else _Ambient(mesh, specs, bool(rows_sharded))):
        yield mesh


def _ambient_mesh():
    """The mesh visible here, or None."""
    amb = _AMBIENT.get()
    return None if amb is None else amb.mesh


def _mesh_axes() -> tuple:
    mesh = _ambient_mesh()
    return tuple(mesh.mesh_dim_names) if mesh is not None else ()


def dp_axes() -> tuple:
    return tuple(a for a in _mesh_axes() if a != "model")


def _size(axis: str) -> int:
    """Ranks along the ambient mesh's named dim (1 where it has none)."""
    return (C.axis_size(_ambient_mesh(), axis) if axis in _mesh_axes()
            else 1)


def _dp_total() -> int:
    return math.prod(_size(a) for a in dp_axes())


def _rows_split() -> bool:
    """Are the activations' batch rows this rank's share over the data
    dims (more than one data rank, rows sharded)?"""
    amb = _AMBIENT.get()
    return amb is not None and amb.rows and _dp_total() > 1


class Partial:
    """This rank's share of a sum over "model": a product whose
    contracted dim the rank holds one block of. It stays pending, as
    GSPMD leaves it, until a constraint names the layout (`constrain`)."""
    __slots__ = ("value",)

    def __init__(self, value: torch.Tensor):
        self.value = value


def constrain(x, *spec):
    """JAX's ``with_sharding_constraint`` against the ambient mesh.

    spec entries: "dp" -> the data axes, "tp" -> "model" (dropped where
    the dim does not divide), None -> unsharded. No mesh set -> identity,
    so reduced-config tests run unchanged on one device. Under a mesh the
    layers compute each activation as the rank's block in the layout its
    constraint names (batch rows over the data axes, a "tp" dim's block
    where the layer's weights hold blocks of it, JAX's divisibility drops
    being the weights' own: `sharding.param_specs`), so a block passes
    unchanged; a `Partial` is summed over "model" in f32, its gradient
    passed back to each share.
    """
    if isinstance(x, Partial):
        if "tp" in spec:
            raise NotImplementedError(
                "a pending sum constrained to a \"tp\" dim "
                "(reduce-scatter) is not ported")
        return C.sum_over(x.value, _ambient_mesh(), "model")
    return x


def _row_product(h: torch.Tensor, w: torch.Tensor, sharded: bool):
    """``h @ w``; a `Partial` where ``w``'s rows are this rank's block of
    the contracted dim (and ``h``'s columns the matching block)."""
    y = h @ w
    return Partial(y) if sharded else y


def _enter(x: torch.Tensor, sharded: bool) -> torch.Tensor:
    """``x``, whole on every rank of "model", as the input of blocks
    computed per rank: its gradient is summed over "model"."""
    return C.sum_grad_over(x, _ambient_mesh(), "model") if sharded else x


class Local(dict):
    """A params dict of a rank's compute blocks under a mesh (`gathered`):
    ``tp`` names its leaves that hold a block over "model"."""
    tp: frozenset = frozenset()


def _tp(p: Params, name: str) -> bool:
    """Does ``p[name]`` hold this rank's block over "model"?"""
    return name in getattr(p, "tp", ())


def gathered(tree: Params, prefix: str, *, stacked: bool = False):
    """The compute weights of a params subtree at ``prefix`` (its
    dot-joined path) under the ambient mesh: every leaf sharded over
    "data" (FSDP) all-gathered there, its gradient reduce-scattered back
    (`collectives.gather_over`); a leaf over "model" stays this rank's
    block and is named in its dict's ``tp``. ``stacked``: one period's
    (or encoder layer's) slice of leaves stacked over periods, whose
    specs lead with the period dim. Without a mesh, or with params whole
    on every rank, ``tree`` itself."""
    amb = _AMBIENT.get()
    if amb is None or not amb.specs:
        return tree
    tp_on = _size("model") > 1

    def walk(node, path):
        out, tp = Local(), set()
        for k, v in node.items():
            at = f"{path}.{k}" if path else k
            if isinstance(v, dict):
                out[k] = walk(v, at)
                continue
            spec = amb.specs[at][1:] if stacked else amb.specs[at]
            for d, entry in enumerate(spec):
                axes = (entry,) if isinstance(entry, str) else (entry or ())
                if "data" in axes:
                    v = C.gather_over(v, amb.mesh, "data", d)
                if "model" in axes and tp_on:
                    tp.add(k)
            out[k] = v
        out.tp = frozenset(tp)
        return out

    return walk(tree, prefix)


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
    if _tp(p, "wk") and _kv_whole(cfg):
        # a column block of K/V whose heads do not divide "model": made
        # whole (JAX's constraint drops "tp"), the cotangent summed and
        # scattered back
        mesh = _ambient_mesh()
        k = C.gather_over(k, mesh, "model", k.dim() - 1)
        v = C.gather_over(v, mesh, "model", v.dim() - 1)
    B, S = x.shape[0], x.shape[1]
    # heads: all of them, or this rank's block under a mesh
    q = constrain(q.reshape(B, S, -1, cfg.head_dim), "dp", None, "tp", None)
    k = constrain(k.reshape(B, S, -1, cfg.head_dim), "dp", None, "tp", None)
    v = constrain(v.reshape(B, S, -1, cfg.head_dim), "dp", None, "tp", None)
    return q, k, v


def _heads_sharded(p: Params, cfg: ModelConfig) -> bool:
    """Are ``p``'s projections this rank's block of the query heads?
    Where the K/V heads divide the model dim, K and V are the rank's
    block of them too; where they do not, K and V are whole on every rank
    (`_qkv`) and each rank's query heads read their group's (`_group_kv`),
    as JAX's `constrain` drops "tp" on K and V there."""
    return _tp(p, "wq")


def _kv_whole(cfg: ModelConfig) -> bool:
    """Under the ambient mesh, are K and V whole on every rank of "model"
    (their heads do not divide it) while the query heads may not be?"""
    return _size("model") > 1 and cfg.n_kv_heads % _size("model") != 0


def _group_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              cfg: ModelConfig):
    """The K/V heads that this rank's block of query heads reads, from K
    and V whole over the heads: (k, v) of (B, S, KV', Dh) with the local
    query heads a multiple of KV' in GQA order."""
    h_loc, G = q.shape[2], cfg.n_heads // cfg.n_kv_heads
    h0 = C.axis_index(_ambient_mesh(), "model") * h_loc
    if G % h_loc == 0:                       # all in one group
        g = h0 // G
        return k[:, :, g:g + 1], v[:, :, g:g + 1]
    if h_loc % G == 0:                       # whole groups
        g = h0 // G
        return k[:, :, g:g + h_loc // G], v[:, :, g:g + h_loc // G]
    idx = torch.div(h0 + torch.arange(h_loc, device=q.device), G,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


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


def _seqpar_flash(q, k, v, *, causal, q_chunk, kv_chunk, mesh, cdtype):
    """Context-parallel attention for archs whose head count doesn't
    divide the model axis (llama3.2: 24 heads, whisper: 6, qwen1.5: 40):
    q is sharded over "model" on the SEQUENCE dim (full heads per shard),
    k/v whole on every rank of it; each rank runs flash over its q rows
    with the global causal offset ``rank * S_loc``, and the rows are put
    back together. JAX's ``shard_map`` body (`repro/models/layers.py`
    ``_seqpar_flash``); k/v enter as f32, so their gradient's sum over
    "model" is an f32 all-reduce, as in JAX."""
    S_loc = q.shape[1] // C.axis_size(mesh, "model")
    qL = C.split_over(q, mesh, "model", 1)
    kF = C.sum_grad_over(k.float(), mesh, "model")
    vF = C.sum_grad_over(v.float(), mesh, "model")
    o = flash_attention(qL, kF, vF, causal=causal,
                        q_chunk=min(q_chunk, S_loc), kv_chunk=kv_chunk,
                        q_offset=C.axis_index(mesh, "model") * S_loc,
                        cdtype=cdtype)
    return C.unsplit_over(o, mesh, "model", 1)


def attention_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, causal: bool = True,
                  use_rope: bool = True, q_chunk: int = 512,
                  kv_chunk: int = 1024):
    """Full-sequence attention (train / prefill) in ``x``'s dtype, the
    compute dtype: causal, with RoPE, by default; the whisper encoder
    runs it bidirectional and without RoPE, its decoder without RoPE.
    Returns (out, (k, v)): under a mesh k and v are this rank's K/V
    heads, or all of them where those do not divide "model".

    Under a mesh whose "model" dim does not divide the heads of a causal
    attention but divides its sequence, the attention is context-parallel
    (`_seqpar_flash`), as in JAX."""
    sharded = _heads_sharded(p, cfg)
    q, k, v = _qkv(p, _enter(x, sharded), cfg)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    mesh = _ambient_mesh()
    tp = _size("model")
    seqpar = (mesh is not None and "model" in _mesh_axes()
              and cfg.n_heads % tp != 0 and q.shape[1] % tp == 0 and causal)
    if seqpar:
        o = _seqpar_flash(q, k, v, causal=causal, q_chunk=q_chunk,
                          kv_chunk=kv_chunk, mesh=mesh, cdtype=x.dtype)
    else:
        kq, vq = (_group_kv(q, k, v, cfg) if sharded and _kv_whole(cfg)
                  else (k, v))
        o = flash_attention(q, kq, vq, causal=causal, q_chunk=q_chunk,
                            kv_chunk=kv_chunk, cdtype=x.dtype)
    B, S = x.shape[0], x.shape[1]
    out = _row_product(o.reshape(B, S, -1), p["wo"], sharded)
    return constrain(out, "dp", None, None), (k, v)


def attention_decode_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                         k_cache: torch.Tensor, v_cache: torch.Tensor,
                         pos: torch.Tensor, use_rope: bool = True):
    """One-token attention step in ``x``'s dtype. x: (B, 1, D); pos: 0-d
    int tensor.

    The new K/V rows are written into ``k_cache``/``v_cache`` at ``pos``
    in place (JAX donates the cache and updates a slice: the same
    semantics, no copy of the cache). Returns (out, (k_cache, v_cache)).

    Under a mesh the cache is laid out by `sharding.cache_specs`: this
    rank's K/V heads where they divide "model" (the rank's query heads
    attend to them and the output's shares are summed), else this rank's
    block of positions with every head (`_decode_seq`).
    """
    sharded = _heads_sharded(p, cfg)
    q, k, v = _qkv(p, _enter(x, sharded), cfg)
    if use_rope:
        ppos = pos.reshape(1, 1).expand(x.shape[0], 1)
        q = apply_rope(q, ppos, cfg.rope_theta)
        k = apply_rope(k, ppos, cfg.rope_theta)
    B = x.shape[0]
    if _kv_whole(cfg):
        o = _decode_seq(q, k, v, k_cache, v_cache, pos, sharded, x.dtype)
    else:
        at = pos.reshape(1).long()
        k_cache.index_copy_(1, at, k.to(k_cache.dtype))
        v_cache.index_copy_(1, at, v.to(v_cache.dtype))
        o = decode_attention(q, k_cache, v_cache, pos, cdtype=x.dtype)
    out = _row_product(o.reshape(B, 1, -1), p["wo"], sharded)
    return constrain(out, "dp", None, None), (k_cache, v_cache)


def _decode_seq(q, k, v, k_cache, v_cache, pos, sharded: bool, cdtype):
    """`decode_attention` against a cache whose positions are split over
    "model" (K/V heads that do not divide it, `sharding.cache_specs`):
    rank r holds positions [r n, (r + 1) n) of every head. The new row is
    written on the rank that holds ``pos`` (the others write back the row
    they hold). Every rank scores all query heads (gathered where it
    holds a block of them) against its positions, masked past ``pos``;
    the softmax is combined over "model" in f32, the maximum first
    (`collectives.pmax`), then the sums of the exponentials, and each
    rank's ``p . v`` over its positions is summed. Returns this rank's
    query heads of the output, (B, 1, H', Dh)."""
    mesh = _ambient_mesh()
    n = k_cache.shape[1]
    r = C.axis_index(mesh, "model")
    loc = pos - r * n
    mine = (loc >= 0) & (loc < n)
    at = torch.clamp(loc, 0, n - 1).reshape(1).long()
    for cache, new in ((k_cache, k), (v_cache, v)):
        cache.index_copy_(1, at, torch.where(mine, new.to(cache.dtype),
                                             cache.index_select(1, at)))
    h_loc = q.shape[2]
    if sharded:
        q = C.gather_along(q, mesh, ("model",), 2)
    B, _, H, Dh = q.shape
    KV = k_cache.shape[2]
    qh = _f32_of(q, cdtype).reshape(B, KV, H // KV, Dh)
    s = torch.einsum("bhgd,bshd->bhgs", qh,
                     _f32_of(k_cache, cdtype)) * Dh ** -0.5
    kpos = r * n + torch.arange(n, device=q.device)
    s = torch.where(kpos[None, None, None, :] <= pos, s, -math.inf)
    m = C.pmax(torch.amax(s, dim=-1, keepdim=True), mesh, "model")
    e = torch.exp(s - m)
    l_ = C.psum([torch.sum(e, dim=-1, keepdim=True)], mesh, ["model"])[0]
    o = torch.einsum("bhgs,bshd->bhgd", _f32_of(e / l_, cdtype),
                     _f32_of(v_cache, cdtype))
    o = C.psum([o], mesh, ["model"])[0].reshape(B, 1, H, Dh).to(q.dtype)
    return o.narrow(2, r * h_loc, h_loc) if sharded else o


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return init_attention(gen, dataclasses.replace(cfg, attn_bias=False))


def cross_attention_fwd(p: Params, x: torch.Tensor,
                        enc_kv: Tuple[torch.Tensor, torch.Tensor],
                        cfg: ModelConfig) -> torch.Tensor:
    """Decoder-side cross attention against precomputed encoder K/V, in
    ``x``'s dtype. Under a mesh that shards the heads, ``enc_kv`` holds
    this rank's heads (`cross_kv`), and the output's shares are summed
    here (the residual stream's constraint)."""
    B, S = x.shape[0], x.shape[1]
    sharded = _heads_sharded(p, cfg)
    q = (_enter(x, sharded) @ p["wq"]).reshape(B, S, -1, cfg.head_dim)
    k, v = enc_kv
    if sharded and _kv_whole(cfg):
        k, v = _group_kv(q, k, v, cfg)
    o = flash_attention(q, k, v, causal=False, cdtype=x.dtype)
    out = _row_product(o.reshape(B, S, -1), p["wo"], sharded)
    return constrain(out, "dp", None, None)


def cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig):
    """The encoder's K/V for the cross attention: (B, S_enc, KV, Dh)
    each (this rank's KV heads where the mesh shards them and they
    divide "model", else all of them)."""
    B, S = enc_out.shape[0], enc_out.shape[1]
    e = _enter(enc_out, _heads_sharded(p, cfg))
    k, v = e @ p["wk"], e @ p["wv"]
    if _tp(p, "wk") and _kv_whole(cfg):
        mesh = _ambient_mesh()
        k = C.gather_over(k, mesh, "model", 2)
        v = C.gather_over(v, mesh, "model", 2)
    return (k.reshape(B, S, -1, cfg.head_dim),
            v.reshape(B, S, -1, cfg.head_dim))


# --------------------------------------------------------------------------
# dense MLP (SwiGLU)
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d: int, f: int) -> Params:
    return {"w_gate": dense_init(gen, d, f),
            "w_up": dense_init(gen, d, f),
            "w_down": dense_init(gen, f, d)}


def mlp_fwd(p: Params, x: torch.Tensor) -> torch.Tensor:
    sharded = _tp(p, "w_gate")
    xin = _enter(x, sharded)
    g = F.silu((xin @ p["w_gate"]).float()).to(x.dtype)
    g = constrain(g, "dp", None, "tp")
    h = g * constrain(xin @ p["w_up"], "dp", None, "tp")
    return constrain(_row_product(h, p["w_down"], sharded), "dp", None, None)


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


def _router(p: Params, xt: torch.Tensor, moe: MoEConfig):
    """(probs, top_p, top_e) of xt (T, D): the f32 router's softmax and
    its top-k, the top-k probabilities renormalised."""
    logits = xt.float() @ p["router"]                          # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, moe.top_k, dim=-1)        # (T, K)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    return probs, top_p, top_e


def _slots(flat_e: torch.Tensor, e_lo: int, e_loc: int, E: int, cap: int):
    """(valid, slot) of each (token, choice) for experts [e_lo, e_lo +
    e_loc) of E: its rank within its expert in token-major order (an
    exclusive cumsum of the one-hot) keeps it while below ``cap``;
    ``slot`` is ``local expert * cap + rank`` where kept, ``e_loc * cap``
    elsewhere. A choice of another rank's expert is never kept."""
    loc, mine = flat_e - e_lo, None
    if e_loc < E:
        mine = (loc >= 0) & (loc < e_loc)
        loc = torch.where(mine, loc, 0)
    onehot = F.one_hot(loc, e_loc)                             # (T*K, e_loc)
    if mine is not None:
        onehot = onehot * mine[:, None]
    rank = torch.sum((torch.cumsum(onehot, dim=0) - onehot) * onehot, dim=-1)
    valid = rank < cap if mine is None else mine & (rank < cap)
    slot = torch.where(valid, loc * cap + rank, e_loc * cap)
    return valid, slot


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
    probs, top_p, top_e = _router(p, xt, moe)
    valid, slot = _slots(top_e.reshape(T * K), 0, E, E, cap)
    return probs, top_p, top_e, valid, slot, cap


def _experts(p: Params, xt, top_p, valid, slot, e_loc: int, cap: int,
             dtype):
    """The combine (T, D) in f32 of the experts ``p`` holds (``e_loc`` of
    them) over the kept (token, choice) rows.

    The kept rows are written at their unique slots of an (e_loc * cap,
    D) buffer (an ``index_put`` with no accumulation, whose backward is a
    gather); the dropped ones are written as zeros into one extra row,
    ``e_loc * cap``, which the combine's gather reads for them (weight
    0), so the gather's backward adds exactly one term into every real
    slot. Two runs give the same bits on the card."""
    T, D = xt.shape
    K = top_p.shape[1]
    x_rep = torch.repeat_interleave(xt, K, dim=0)              # (T*K, D)
    w = torch.where(valid, top_p.reshape(T * K), 0.0)
    buf = torch.zeros((e_loc * cap + 1, D), dtype=dtype, device=xt.device)
    buf = buf.index_put((slot,), torch.where(valid[:, None], x_rep, 0.0))
    buf = buf[:e_loc * cap].reshape(e_loc, cap, D)

    bf = buf.float()
    g = F.silu(torch.bmm(bf, p["w_gate"].float()))
    u = torch.bmm(bf, p["w_up"].float())
    y = torch.bmm((g * u).to(dtype).float(), p["w_down"].float())
    y = torch.cat([y.reshape(e_loc * cap, D), y.new_zeros((1, D))])

    y_tok = y[slot]                                            # (T*K, D)
    return torch.sum((y_tok * w[:, None]).reshape(T, K, D), dim=1)


def _aux(probs: torch.Tensor, top_e: torch.Tensor, E: int) -> torch.Tensor:
    """Switch's load-balance loss: ``E * sum(mean(probs) *
    mean(onehot(top-1 expert)))``."""
    me = torch.mean(probs, dim=0)                              # (E,)
    ce = torch.mean(F.one_hot(top_e[:, 0], E).float(), dim=0)
    return E * torch.sum(me * ce)


def moe_fwd(p: Params, x: torch.Tensor, moe: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k MoE. x: (B, S, D) -> (out in x's dtype, f32
    aux).

    Under a mesh with a "model" dim, S > 1, experts that divide the dim
    and the batch rows split over the data dims (or one data rank), this
    routes to ``_moe_fwd_ep``, JAX's expert-parallel dispatch. Otherwise
    JAX's single-device (GShard-style, sort-free) dispatch runs over the
    global batch's tokens: `moe_route`, then `_experts`; under a mesh
    that is `_moe_fwd_global` (S == 1, decode, stays on it in JAX too).
    """
    mesh = _ambient_mesh()
    if mesh is not None and "model" in _mesh_axes():
        if (x.shape[1] > 1 and moe.n_experts % _size("model") == 0
                and (_rows_split() or _dp_total() == 1)):
            return _moe_fwd_ep(p, x, moe, mesh)
        return _moe_fwd_global(p, x, moe, mesh)
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    probs, top_p, top_e, valid, slot, cap = moe_route(p, xt, moe)
    out = _experts(p, xt, top_p, valid, slot, moe.n_experts, cap, x.dtype)
    return (out.reshape(B, S, D).to(x.dtype),
            _aux(probs, top_e, moe.n_experts))


def _moe_fwd_global(p: Params, x: torch.Tensor, moe: MoEConfig, mesh
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's single-device dispatch (``_moe_fwd_dense``) as GSPMD runs it
    under a mesh: routing, capacity and each (token, choice)'s rank over
    the GLOBAL batch's tokens, so the rows split over the data dims are
    gathered first (each rank's cotangent of them its own rows). Where
    the expert stacks are this rank's block over "model" (`param_specs`),
    the rank runs its experts' slots and the combine's shares are summed
    over "model" in f32; else every rank runs all of them. Each rank keeps
    its own rows of the output. At one rank it is the single-device
    dispatch, op for op."""
    B_loc, S, D = x.shape
    xt = x.reshape(B_loc * S, D)
    dp = dp_axes() if _rows_split() else ()
    for ax in reversed(dp):
        xt = C.unsplit_over(xt, mesh, ax, 0)
    E = moe.n_experts
    probs, top_p, top_e, valid, slot, cap = moe_route(p, xt, moe)
    if _tp(p, "w_gate"):
        e_loc = E // _size("model")
        valid, slot = _slots(top_e.reshape(-1),
                             C.axis_index(mesh, "model") * e_loc, e_loc, E,
                             cap)
        part = _experts(p, _enter(xt, True), _enter(top_p, True), valid,
                        slot, e_loc, cap, x.dtype)
        out = C.sum_over(part.float(), mesh, "model")
    else:
        out = _experts(p, xt, top_p, valid, slot, E, cap, x.dtype)
    if dp:
        n = B_loc * S
        out = out.narrow(0, C.linear_index(mesh, dp) * n, n)
    return out.reshape(B_loc, S, D).to(x.dtype), _aux(probs, top_e, E)


def _moe_fwd_ep(p: Params, x: torch.Tensor, moe: MoEConfig, mesh
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's expert-parallel dispatch (`repro/models/layers.py`
    ``_moe_fwd_ep``), a ``shard_map`` body run by every (data, model)
    rank on its blocks.

    Each rank buckets ITS OWN data shard's tokens for ITS OWN ``E / tp``
    experts entirely locally, with a local capacity (``cf * T_local * K /
    E`` per expert, the per-shard capacity of EP systems): the router and
    its top-k run whole on every rank of "model", the tokens and their
    weights enter the rank's experts (`_enter`), and the combine's shares
    are summed over "model" in f32. The expert stacks arrive FSDP-gathered
    over "data" (`gathered`). The aux loss is averaged over the data
    dims.
    """
    if not _tp(p, "w_gate") and _size("model") > 1:
        raise NotImplementedError(
            "the expert-parallel dispatch needs the expert stacks laid out "
            "by param_specs (use_mesh's param_specs)")
    B_loc, S, D = x.shape
    T = B_loc * S
    E, K = moe.n_experts, moe.top_k
    e_loc = E // _size("model")
    cap = int(moe.capacity_factor * T * K / E + 0.999)
    xt = x.reshape(T, D)
    probs, top_p, top_e = _router(p, xt, moe)
    sharded = e_loc < E
    valid, slot = _slots(top_e.reshape(T * K),
                         C.axis_index(mesh, "model") * e_loc, e_loc, E, cap)
    part = _experts(p, _enter(xt, sharded), _enter(top_p, sharded), valid,
                    slot, e_loc, cap, x.dtype)
    out = C.sum_over(part.float(), mesh, "model")
    aux = _aux(probs, top_e, E)
    for ax in dp_axes():
        aux = C.sum_over(aux, mesh, ax)
    if _dp_total() > 1:
        aux = aux / _dp_total()
    return out.reshape(B_loc, S, D).to(x.dtype), aux


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


#: the Mamba leaves that hold a block of d_inner (or of its heads) over
#: "model" when the mixer is sharded (`sharding._leaf_rule`)
_MAMBA_TP = ("wz", "wx", "wdt", "conv_x", "A_log", "D", "dt_bias", "norm",
             "out_proj")


def _mamba_sharded(p: Params) -> bool:
    """Is ``p``'s mixer this rank's block of the heads? All of its
    d_inner leaves must then hold blocks."""
    held = [_tp(p, n) for n in _MAMBA_TP]
    if any(held) and not all(held):
        raise NotImplementedError(
            "a Mamba mixer whose d_inner leaves shard over the model dim "
            "but not all of them (its heads do not divide it) is not "
            "ported")
    return all(held)


def _ssd_proj(p: Params, u: torch.Tensor, ssm: SSMConfig, d: int,
              conv_state: Optional[Dict[str, torch.Tensor]]):
    """Project u -> (z, x, B, C, dt) and run the causal convs. Under a
    mesh that shards the mixer, z, x and dt are this rank's heads; B and
    C, shared by all heads, are computed whole and enter the heads'
    blocks (their gradient summed over "model")."""
    d_in = ssm.expand * d
    nh = d_in // ssm.head_dim
    gn = ssm.n_groups * ssm.d_state
    sharded = _mamba_sharded(p)
    uin = _enter(u, sharded)
    z = constrain(uin @ p["wz"], "dp", None, "tp")
    xr = constrain(uin @ p["wx"], "dp", None, "tp")
    bc = torch.cat([u @ p["wB"], u @ p["wC"]], dim=-1)
    dt = constrain(uin @ p["wdt"], "dp", None, "tp")
    cs_x = None if conv_state is None else conv_state["x"]
    cs_bc = None if conv_state is None else conv_state["bc"]
    xr, ns_x = _causal_conv(xr, p["conv_x"], cs_x)
    bc, ns_bc = _causal_conv(bc, p["conv_bc"], cs_bc)
    Bm, Cm = torch.chunk(_enter(bc, sharded), 2, dim=-1)
    return z, xr, Bm, Cm, dt, d_in, nh, gn, {"x": ns_x, "bc": ns_bc}


def _gated_out(p: Params, y: torch.Tensor, z: torch.Tensor,
               d_in: Optional[int] = None) -> torch.Tensor:
    """``rms_norm(y * silu(z))`` in y's dtype (JAX's gated norm). Given
    ``d_in``, y holds this rank's block of d_inner: its mean square is
    the sum over "model" of the blocks' sums of squares over ``d_in``."""
    v = y * _silu_as(z, y.dtype)
    if d_in is None:
        return rms_norm(v, p["norm"], 1e-5)
    vf = v.float()
    ss = C.sum_both_over(torch.sum(vf * vf, dim=-1, keepdim=True),
                         _ambient_mesh(), "model")
    out = vf * torch.rsqrt(ss / d_in + 1e-5) * p["norm"].float()
    return out.to(v.dtype)


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
    sharded = _mamba_sharded(p)
    # this rank's heads [h0, h0 + nh) under a mesh that shards the mixer
    h0 = 0
    if sharded:
        nh = xs.shape[-1] // hd
        h0 = C.axis_index(_ambient_mesh(), "model") * nh

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
        if sharded:
            Bg, Cg = Bg[:, :, h0:h0 + nh], Cg[:, :, h0:h0 + nh]
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
    y = constrain(y.reshape(B, L, nh * hd).to(cd), "dp", None, "tp")
    y = _gated_out(p, y, z, d_in if sharded else None)
    if pad:
        y = y[:, pad:]
    out = constrain(_row_product(y, p["out_proj"], sharded), "dp", None, None)
    if return_state:
        return out, {"ssm": state, "conv": conv_out_state}
    return out


def mamba_decode_fwd(p: Params, u: torch.Tensor, ssm: SSMConfig, d: int,
                     state: Dict[str, Any]):
    """Single-token SSM step. u: (B, 1, D); state: {ssm, conv: {x, bc}}.
    Returns (out, new state), the state in new tensors. Under a mesh that
    shards the mixer, the SSM state and the conv state of x hold this
    rank's heads (`sharding.cache_specs`), as in `mamba_fwd`."""
    B = u.shape[0]
    z, xs, Bm, Cm, dt, d_in, nh, gn, conv_state = \
        _ssd_proj(p, u, ssm, d, state["conv"])
    hd, N, G = ssm.head_dim, ssm.d_state, ssm.n_groups
    hpg = nh // G
    sharded = _mamba_sharded(p)
    h0, nh_l = 0, nh
    if sharded:
        nh_l = xs.shape[-1] // hd
        h0 = C.axis_index(_ambient_mesh(), "model") * nh_l
    xh = xs.reshape(B, nh_l, hd).float()
    Bh = torch.repeat_interleave(Bm.reshape(B, G, N), hpg, dim=1).float()
    Ch = torch.repeat_interleave(Cm.reshape(B, G, N), hpg, dim=1).float()
    if sharded:
        Bh, Ch = Bh[:, h0:h0 + nh_l], Ch[:, h0:h0 + nh_l]
    dtv = _softplus(dt.float() + p["dt_bias"]).reshape(B, nh_l)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dtv * A[None, :])                        # (B,nh)
    st = state["ssm"] * decay[:, :, None, None] \
        + torch.einsum("bhp,bhn->bhpn", xh * dtv[..., None], Bh)
    y = torch.einsum("bhpn,bhn->bhp", st, Ch) + xh * p["D"][None, :, None]
    y = _gated_out(p, y.reshape(B, 1, nh_l * hd).to(u.dtype), z,
                   d_in if sharded else None)
    out = constrain(_row_product(y, p["out_proj"], sharded), "dp", None, None)
    return out, {"ssm": st, "conv": conv_state}

"""Config dataclasses for the model zoo and the k-means engine.

Everything is a frozen dataclass so configs are hashable. Port of
`repro/configs/base.py`, a copy.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert_ff: int
    # capacity factor: per-expert token capacity = tokens * top_k / n_experts * cf
    capacity_factor: float = 1.25
    # which layers are MoE; "all" | "alternate" (odd layers dense)
    layout: str = "all"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    d_conv: int = 4
    head_dim: int = 64          # mamba2 SSD head size
    chunk: int = 256            # SSD chunk length
    n_groups: int = 1           # B/C groups


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper) / frontend-stub (vlm) archs."""
    n_layers: int = 0
    n_ctx: int = 0              # encoder context length (frames / patches)
    d_frontend: int = 0         # dim of the precomputed stub embeddings


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid: one attention layer per `hybrid_period` layers (rest SSM)
    hybrid_period: int = 0
    attn_bias: bool = False     # qwen1.5-style QKV bias
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # set for archs whose quadratic attention makes long_500k infeasible
    full_attention_only: bool = True

    # ---- derived helpers -------------------------------------------------
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_attention_layer(self, layer_idx: int) -> bool:
        if self.family not in ("hybrid",):
            return self.family != "ssm"
        return layer_idx % self.hybrid_period == 0

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.layout == "all":
            return True
        return layer_idx % 2 == 1  # alternate: odd layers MoE

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), used for 6ND."""
        d = self.d_model
        n = 0
        n += self.vocab * d                     # embed
        if not self.tie_embeddings:
            n += self.vocab * d                 # lm head
        for i in range(self.n_layers):
            if self.family == "ssm" or (self.family == "hybrid"
                                        and not self.is_attention_layer(i)):
                n += self._mamba_params()
            else:
                n += d * self.q_dim() + 2 * d * self.kv_dim() \
                     + self.q_dim() * d
                if self.attn_bias:
                    n += self.q_dim() + 2 * self.kv_dim()
            # mlp
            if self.is_moe_layer(i):
                m = self.moe
                n += m.n_experts * 3 * d * m.d_expert_ff + d * m.n_experts
            elif self.family != "ssm":
                n += 3 * d * self.d_ff
            n += 2 * d                           # norms
        if self.encoder is not None and self.encoder.n_layers:
            de = d
            per = 4 * de * de + 3 * de * self.d_ff + 2 * de
            n += self.encoder.n_layers * per
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        m = self.moe
        total = self.param_count()
        moe_layers = sum(1 for i in range(self.n_layers) if self.is_moe_layer(i))
        all_exp = moe_layers * m.n_experts * 3 * d * m.d_expert_ff
        act_exp = moe_layers * m.top_k * 3 * d * m.d_expert_ff
        return total - all_exp + act_exp

    def _mamba_params(self) -> int:
        s = self.ssm or SSMConfig()
        d = self.d_model
        d_in = s.expand * d
        nh = d_in // s.head_dim
        n = 0
        n += d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)  # in_proj (z,x,B,C,dt)
        n += s.d_conv * (d_in + 2 * s.n_groups * s.d_state)    # conv over x,B,C
        n += nh * 2                                            # A_log, D
        n += d_in * d                                          # out_proj
        return n


@dataclass(frozen=True)
class KMeansConfig:
    """Workload config for the paper's technique."""
    name: str
    n_points: int
    dim: int
    k: int
    dtype: str = "float32"
    # engine knobs
    algorithm: str = "tb"       # lloyd | mb | mbf | gb | tb
    rho: float = float("inf")
    b0: int = 5000
    bounds: str = "hamerly2"    # none | elkan | hamerly2
    # distribution: shard centroids over "model" when k is large
    shard_centroids: bool = False


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    def __str__(self) -> str:  # pragma: no cover
        return f"{self.name}(L={self.seq_len},B={self.global_batch},{self.kind})"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)

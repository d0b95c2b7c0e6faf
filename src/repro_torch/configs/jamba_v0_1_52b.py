"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Attention every 8th layer; MoE on alternating layers (16 experts, top-2).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, replace

CONFIG = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert_ff=14336, layout="alternate"),
    ssm=SSMConfig(d_state=16, expand=2, d_conv=4, head_dim=64, chunk=256),
    hybrid_period=8,
    full_attention_only=False,   # hybrid: runs long_500k
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert_ff=128, layout="alternate"),
        ssm=SSMConfig(d_state=8, expand=2, d_conv=4, head_dim=16, chunk=16),
        hybrid_period=2,
    )

"""Qwen3-MoE 235B-A22B — 128 experts, top-8, all layers MoE.

[hf:Qwen/Qwen3-30B-A3B family scaled] 94L d_model=4096 64H (GQA kv=4)
expert d_ff=1536 vocab=151936, MoE 128e top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, replace

CONFIG = ModelConfig(
    arch_id="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert_ff=1536, layout="all"),
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert_ff=64, layout="all"),
    )

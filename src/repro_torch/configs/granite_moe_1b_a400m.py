"""Granite-3.0 1B-A400M MoE — 32 experts, top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d_model=1024 16H (GQA kv=8)
expert d_ff=512 vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, replace

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert_ff=512, layout="all"),
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab=512,
        moe=MoEConfig(n_experts=8, top_k=4, d_expert_ff=64, layout="all"),
    )

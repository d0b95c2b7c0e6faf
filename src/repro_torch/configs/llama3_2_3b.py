"""Llama 3.2 3B — small llama3 dense model.

[hf:meta-llama/Llama-3.2-3B] 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256.
"""
from repro_torch.configs.base import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=128256,
    rope_theta=500000.0,
)


def reduced() -> ModelConfig:
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   head_dim=16, d_ff=128, vocab=512)

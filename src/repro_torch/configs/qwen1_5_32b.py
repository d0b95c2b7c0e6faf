"""Qwen1.5 32B — dense, QKV bias, MHA (kv=heads).

[hf:Qwen/Qwen1.5-32B family] 64L d_model=5120 40H (kv=40) d_ff=27392
vocab=152064.
"""
from repro_torch.configs.base import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab=152064,
    attn_bias=True,
)


def reduced() -> ModelConfig:
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   head_dim=16, d_ff=128, vocab=512)

"""CodeQwen1.5 7B — qwen1.5 architecture (QKV bias), MHA (kv=heads).

[hf:Qwen/CodeQwen1.5-7B] 32L d_model=4096 32H (kv=32) d_ff=13440 vocab=92416.
"""
from repro_torch.configs.base import ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=13440,
    vocab=92416,
    attn_bias=True,
)


def reduced() -> ModelConfig:
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   head_dim=16, d_ff=128, vocab=512)

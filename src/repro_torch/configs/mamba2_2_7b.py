"""Mamba2 2.7B — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060] 64L d_model=2560 (attn-free) vocab=50280, ssm_state=128.
d_inner = 2*d_model = 5120, 80 SSD heads of size 64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, replace

CONFIG = ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, expand=2, d_conv=4, head_dim=64, chunk=256),
    full_attention_only=False,   # attention-free: runs long_500k
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG, n_layers=2, d_model=64, vocab=512,
        ssm=SSMConfig(d_state=8, expand=2, d_conv=4, head_dim=16, chunk=16),
    )

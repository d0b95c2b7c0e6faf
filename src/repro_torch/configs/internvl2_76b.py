"""InternVL2-76B — VLM: InternViT frontend (stub) + InternLM2-like LM backbone.

[arXiv:2404.16821] 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, 256, d_model) prepended to the token sequence.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    encoder=EncoderConfig(n_layers=0, n_ctx=256, d_frontend=8192),
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512,
        encoder=EncoderConfig(n_layers=0, n_ctx=8, d_frontend=64),
    )

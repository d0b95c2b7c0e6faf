"""Whisper-tiny — encoder-decoder audio transformer, conv frontend stubbed.

[arXiv:2212.04356] 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865.
The conv frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, 1536, 384). Encoder ctx padded 1500 -> 1536 for clean tiling.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig, replace

CONFIG = ModelConfig(
    arch_id="whisper-tiny",
    family="encdec",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    encoder=EncoderConfig(n_layers=4, n_ctx=1536, d_frontend=384),
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512,
        encoder=EncoderConfig(n_layers=2, n_ctx=32, d_frontend=64),
    )

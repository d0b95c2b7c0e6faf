"""Architecture registry: ``get_config(arch_id)`` / ``get_reduced(arch_id)``.

Every assigned architecture is a selectable config (``--arch <id>``).

Port of `repro/configs/__init__.py`, with the ten architecture files and
`kmeans_workloads.py` beside it: copies, since the port imports nothing
of `repro` (the tests hold every config equal to the JAX package's).
The port's model runs every family of them.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                                TRAIN_4K, KMeansConfig, ModelConfig,
                                ShapeConfig)
from repro_torch.configs import (codeqwen1_5_7b, granite_moe_1b_a400m,
                           internvl2_76b, jamba_v0_1_52b, llama3_2_3b,
                           mamba2_2_7b, qwen1_5_32b, qwen3_moe_235b_a22b,
                           tinyllama_1_1b, whisper_tiny)
from repro_torch.configs.kmeans_workloads import KMEANS_WORKLOADS

_MODULES = {
    "jamba-v0.1-52b": jamba_v0_1_52b,
    "whisper-tiny": whisper_tiny,
    "internvl2-76b": internvl2_76b,
    "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b,
    "granite-moe-1b-a400m": granite_moe_1b_a400m,
    "tinyllama-1.1b": tinyllama_1_1b,
    "llama3.2-3b": llama3_2_3b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "qwen1.5-32b": qwen1_5_32b,
    "mamba2-2.7b": mamba2_2_7b,
}

ARCHS: Dict[str, ModelConfig] = {k: m.CONFIG for k, m in _MODULES.items()}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def get_reduced(arch_id: str) -> ModelConfig:
    return _MODULES[arch_id].reduced()


def list_archs() -> List[str]:
    return list(ARCHS)


def shapes_for(cfg: ModelConfig) -> List[ShapeConfig]:
    """The shape cells this arch runs (long_500k only for sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if not cfg.full_attention_only:
        out.append(LONG_500K)
    return out


def skipped_shapes_for(cfg: ModelConfig) -> List[ShapeConfig]:
    return [] if not cfg.full_attention_only else [LONG_500K]


def get_kmeans_config(name: str) -> KMeansConfig:
    return KMEANS_WORKLOADS[name]


__all__ = [
    "ARCHS", "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "get_config", "get_reduced", "list_archs", "shapes_for",
    "skipped_shapes_for", "get_kmeans_config", "KMEANS_WORKLOADS",
]

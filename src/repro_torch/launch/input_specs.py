"""Shape and dtype stand-ins for every model input (no allocation).

Port of `repro/launch/input_specs.py`. JAX's ``ShapeDtypeStruct`` trees
are trees of tensors on the ``meta`` device here: each has the leaf's
shape and dtype and holds no memory. The sharding rules
(`repro_torch.models.sharding`) read them at full width, where a model
such as qwen3-moe-235b-a22b could not be made for real.

`abstract_params` runs `repro_torch.models.model.init_params` under
`FakeTensorMode` (its `torch.Generator` draws need a real device, which
the meta device is not): the tree has the real one's paths, shapes and
dtypes, and nothing is drawn or allocated.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.util.tree import tree_map

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def token_split(cfg: ModelConfig, S: int) -> Tuple[int, int]:
    """(prefix_len, token_len): VLM reserves a patch prefix inside S."""
    if cfg.family == "vlm":
        p = cfg.encoder.n_ctx
        return p, S - p
    return 0, S


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    p, st = token_split(cfg, S)
    batch = {"tokens": _sds((B, st), torch.int32),
             "labels": _sds((B, st), torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _sds((B, cfg.encoder.n_ctx,
                                cfg.encoder.d_frontend), L.CDTYPE)
    if cfg.family == "vlm":
        batch["patches"] = _sds((B, p, cfg.d_model), L.CDTYPE)
    return batch


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    b = train_batch_specs(cfg, shape)
    b.pop("labels")
    return b


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """token + KV/SSM cache stand-ins for one decode step."""
    B, S = shape.global_batch, shape.seq_len
    cache = M.make_decode_cache(cfg, batch=B, cache_len=S, dtype=L.CDTYPE,
                                device=META)
    return {"token": _sds((B, 1), torch.int32), "cache": cache}


def abstract_params(cfg: ModelConfig):
    """The params tree of ``cfg`` at full width as meta tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = M.init_params(0, cfg, "cpu")
    return tree_map(lambda t: _sds(t.shape, t.dtype), fake)


def abstract_opt_state(params_shape) -> adamw.AdamWState:
    return adamw.init(params_shape)

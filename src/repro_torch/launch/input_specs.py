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

import functools
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


@functools.lru_cache(maxsize=8)
def abstract_params(cfg: ModelConfig):
    """The params tree of ``cfg`` at full width as meta tensors (kept for
    the last few configs: the dry run asks for each many times; read it,
    do not change it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = M.init_params(0, cfg, "cpu")
    return tree_map(lambda t: _sds(t.shape, t.dtype), fake)


def abstract_opt_state(params_shape) -> adamw.AdamWState:
    return adamw.init(params_shape)


def materialize(tree, seed: int = 0, device="cuda"):
    """Turn a spec tree into real tensors on ``device`` (smoke tests,
    reduced configs): JAX's rules, leaf by leaf in the tree's order (the
    nested dicts' key order): an integer leaf uniform in [0, 128), a
    float leaf N(0, 1) drawn in f32 and cast to the leaf's dtype. JAX
    folds the leaf's index into ``PRNGKey(seed)``; the port draws every
    leaf in turn from one `torch.Generator` seeded with ``seed`` on
    ``device``, so the structure, shapes, dtypes and ranges are JAX's and
    the bits are not."""
    from repro_torch.kernels._build import resolve_device
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def leaf(t):
        if t.dtype.is_floating_point:
            return torch.randn(tuple(t.shape), generator=gen,
                               dtype=torch.float32, device=device).to(t.dtype)
        if t.dtype == torch.bool:
            return torch.randint(0, 2, tuple(t.shape), generator=gen,
                                 device=device).bool()
        return torch.randint(0, 128, tuple(t.shape), generator=gen,
                             dtype=t.dtype, device=device)

    def build(node):
        if isinstance(node, dict):
            drawn = {k: build(node[k]) for k in sorted(node)}
            return {k: drawn[k] for k in node}
        return leaf(node)
    return build(tree)

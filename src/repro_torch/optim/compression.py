"""int8 gradient compression with error feedback (cross-pod all-reduce).

Port of `repro/optim/compression.py`. Quantising a gradient to int8 with
a per-tensor scale cuts an all-reduce's volume 4x (f32) or 2x (bf16).
Error feedback keeps the quantisation noise unbiased over steps: the
residual e_t is added back before the next quantisation, so the *sum*
of transmitted grads converges to the true sum (Karimireddy et al.,
2019).

Where JAX reduces over a named mesh axis inside ``shard_map``, the port
reduces over a `torch.distributed` process group: a MAX all-reduce of
each tensor's scale, so every rank decodes with the same one, then a SUM
all-reduce of the int32 codes. Over one rank (or with no group up) both
are the identity and call no backend, as in `repro_torch.core
.collectives`. ``torch.round`` rounds half to even, as ``jnp.round``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.util.tree import tree_map


def encode(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(int8 quantised, per-tensor scale, error-feedback residual)."""
    gf = g.float()
    scale = torch.max(torch.abs(gf)) / 127.0
    safe = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(gf / safe), -127, 127).to(torch.int8)
    err = gf - q.float() * safe
    return q, scale, err


def decode(q_sum: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q_sum.float() * torch.clamp(scale, min=1e-30)


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def compressed_psum(tree: Any, err_tree: Any, group=None):
    """Error-feedback int8 sum of a gradient tree over the ranks of
    ``group`` (the default group when None).

    Returns (summed f32 grads, new error-feedback tree). Each tensor's
    scale is the ranks' maximum, so every rank decodes the same sum.
    """
    many = _world(group) > 1

    def one(g, e):
        gf = g.float() + e
        s = torch.max(torch.abs(gf)) / 127.0
        if many:
            dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
        safe = torch.clamp(s, min=1e-30)
        q = torch.clamp(torch.round(gf / safe), -127, 127)
        q_sum = q.to(torch.int32)
        if many:
            dist.all_reduce(q_sum, group=group)
        err = gf - q * safe
        return decode(q_sum, s), err

    out = tree_map(one, tree, err_tree)
    # tuples are leaves of a tree of dicts: split the (sum, err) pairs
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)

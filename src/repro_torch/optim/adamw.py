"""AdamW with f32 moments, decoupled weight decay and cosine schedule.

Port of `repro/optim/adamw.py`: plain functions on trees of tensors (the
nested dicts of `repro_torch.models.model`). Params may be stored bf16;
the update math runs in f32 and is cast back to each parameter's dtype.
Weight decay applies to matrices only (``ndim > 1``). ``count`` is a 0-d
int32 tensor on the parameters' device, and the learning rate and the
global norm stay tensors there too, so a step reads nothing back to the
host.

`update` writes the new parameters, moments and count into the tensors
it was given, as JAX's jitted train step takes them donated
(``donate_argnums=(0, 1)``): the returned trees hold the same tensors,
and the old values are gone. Only one leaf's f32 temporaries live
beside them.

On a mesh (``specs`` and ``mesh`` given) each rank holds its block of
every leaf, laid out by its spec, and the count whole. The update is
elementwise, so each rank updates its blocks; the clip's global norm
sums each leaf's squares over the ranks that hold its blocks, so every
rank applies the same scale.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import collectives as C
from repro_torch.util.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def init(params) -> AdamWState:
    """Zero f32 moments shaped as ``params`` and a 0-d int32 count on the
    parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=device))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to
    ``cfg.min_lr_ratio * cfg.lr`` at ``cfg.decay_steps`` (f32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, the leaves added
    in JAX's order. On a mesh ``tree`` holds this rank's blocks, laid out
    by ``specs``: each leaf's sum of squares is summed over the axes that
    shard it first, so every rank gets the same bits."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if mesh is not None:
        from repro_torch.models.sharding import spec_axes
        groups: dict = {}
        for i, spec in enumerate(tree_leaves(specs)):
            groups.setdefault(spec_axes(spec), []).append(i)
        for axes, idx in groups.items():
            whole = C.psum([torch.stack([sums[i] for i in idx])], mesh,
                           axes)[0]
            for j, i in enumerate(idx):
                sums[i] = whole[j]
    return torch.sqrt(sum(sums))


def update(params, grads, state: AdamWState, cfg: AdamWConfig, *,
           specs=None, mesh=None):
    """One AdamW step, in place (see the module's docstring). Returns
    (params, state, metrics), the metrics ``{"lr", "grad_norm"}`` as 0-d
    tensors. On a mesh, ``specs`` lays out the rank's blocks."""
    count = state.count + 1
    lr = schedule(cfg, count)
    gnorm = global_norm(grads, specs, mesh)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1c = 1 - torch.pow(cfg.b1, count.float())
    b2c = 1 - torch.pow(cfg.b2, count.float())

    def leaf(p, g, m, n):
        g = g.float() * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        n2 = cfg.b2 * n + (1 - cfg.b2) * g * g
        upd = (m2 / b1c) / (torch.sqrt(n2 / b2c) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (upd + cfg.weight_decay * pf * float(p.ndim > 1))
        p.copy_(pf)            # rounds to the parameter's dtype
        m.copy_(m2)
        n.copy_(n2)

    with torch.no_grad():
        tree_map(leaf, params, grads, state.mu, state.nu)
        state.count.copy_(count)
    return params, state, {"lr": lr, "grad_norm": gnorm}

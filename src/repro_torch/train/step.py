"""Training and serving step builders (the functions the launchers call).

Port of `repro/train/step.py`. ``make_train_step`` builds one step:
  batch (B, S) -> (n_micro, B/n_micro, S) -> a loop over the microbatches,
  each the gradient of `train_loss` (remat'ed backbone) added into an
  ``accum_dtype`` buffer (f32 by default) in JAX's order -> the mean
  -> AdamW.
JAX scans the microbatches inside one jitted program; the port loops on
the host and launches each microbatch's forward and backward in turn.
JAX's jitted step takes params and the optimizer state donated
(``donate_argnums=(0, 1)``); the port's step writes the update into
their tensors in place (`adamw.update`) and returns them, so one copy
of each lives at a time, plus the f32 accumulators.

The serving steps, `make_prefill_step` and `make_decode_step`, run
under `torch.inference_mode()`. The decode step takes the cache as JAX's
jitted step takes it donated (``donate_argnums=(2,)``): the new K/V rows
are written into the cache's tensors in place
(`repro_torch.models.model.decode_step`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.util.tree import tree_leaves, tree_map


def shard_batch(batch: Dict[str, torch.Tensor], n_micro: int):
    """Each array (B, ...) as (n_micro, B / n_micro, ...)."""
    def r(x):
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])
    return {k: r(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, *, n_micro: int = 1,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    remat: bool = True, accum_dtype=torch.float32):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr", "grad_norm"})``, the metrics 0-d tensors on the
    device. ``params`` and ``opt_state`` are updated in place and
    returned (donated). ``accum_dtype``: the gradient accumulators'
    dtype, f32 by default, as in JAX."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor]):
        mbs = shard_batch(batch, n_micro)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        for i in range(n_micro):
            # leaves that share the params' memory and take gradients
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            loss, _ = M.train_loss(live, {k: v[i] for k, v in mbs.items()},
                                   cfg, remat=remat)
            grads = torch.autograd.grad(loss, tree_leaves(live))
            with torch.no_grad():
                for a, g in zip(tree_leaves(acc), grads):
                    a.add_(g.to(a.dtype))
            loss_sum = loss_sum + loss.detach()
            del live, loss, grads
        with torch.no_grad():
            # in place where the buffers are f32: no second copy
            grads = tree_map(lambda g: g.float().div_(n_micro), acc)
        del acc
        params, opt_state, om = adamw.update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss_sum / n_micro, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, cache_len: int):
    def prefill_step(params, batch):
        with torch.inference_mode():
            return M.prefill(params, batch, cfg, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, cache):
        with torch.inference_mode():
            return M.decode_step(params, token, cache, cfg)
    return decode_step

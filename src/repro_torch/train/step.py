"""Training and serving step builders (the functions the launchers call).

Port of `repro/train/step.py`. ``make_train_step`` builds one step:
  batch (B, S) -> (n_micro, B/n_micro, S) -> a loop over the microbatches,
  each the gradient of `train_loss` (remat'ed backbone) added into an
  ``accum_dtype`` buffer (f32 by default) in JAX's order -> the mean
  -> AdamW.
JAX scans the microbatches inside one jitted program; the port loops on
the host and launches each microbatch's forward and backward in turn
(`op_cost.loop`, which the dry run's cost model folds into one traced
trip, as JAX's cost model multiplies a scan's body by its trips).
JAX's jitted step takes params and the optimizer state donated
(``donate_argnums=(0, 1)``); the port's step writes the update into
their tensors in place (`adamw.update`) and returns them, so one copy
of each lives at a time, plus the f32 accumulators.

With a ``mesh`` (a `DeviceMesh` with JAX's axis names, one rank a
process) the step is JAX's sharded one, jitted with the params and the
AdamW moments laid out by `sharding.param_specs` (FSDP over "data", TP
over "model") and the batch by `sharding.batch_specs`: each rank passes
its blocks and its rows, and the step runs `train_loss` under
`layers.use_mesh`. Microbatch i is global rows [i * B / n_micro,
(i + 1) * B / n_micro) of the batch, as JAX's `shard_batch` cuts it, each
data rank taking its share of them; the gradients come back laid out as
their params (the FSDP gather's backward reduce-scatters over "data",
and a leaf whole over a data axis has its gradient summed over it after
the microbatches).

The serving steps, `make_prefill_step` and `make_decode_step`, run
under `torch.inference_mode()`. The decode step takes the cache as JAX's
jitted step takes it donated (``donate_argnums=(2,)``): the new K/V rows
are written into the cache's tensors in place
(`repro_torch.models.model.decode_step`). With a ``mesh`` they are JAX's
steps jitted with ``in_shardings`` (`repro/launch/dryrun.py`), each rank
passing its blocks of the params, the batch or token and the cache, and
`whole_logits` puts the logits' blocks together.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.utils._pytree as pytree

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.kernels._build import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.roofline import op_cost
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
                    remat: bool = True, accum_dtype=torch.float32,
                    mesh=None, device="cuda"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "lr", "grad_norm"})``, the metrics 0-d tensors on the
    device. ``params`` and ``opt_state`` are updated in place and
    returned (donated). ``accum_dtype``: the gradient accumulators'
    dtype, f32 by default, as in JAX. With a ``mesh`` the sharded step
    (see the module's docstring), whose blocks must lie on ``device``."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    if mesh is not None:
        return _sharded_train_step(cfg, mesh, n_micro, opt_cfg, remat,
                                   accum_dtype, resolve_device(device))

    def train_step(params, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor]):
        mbs = shard_batch(batch, n_micro)
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        for i in op_cost.loop(n_micro):
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


def _sharded_train_step(cfg: ModelConfig, mesh, n_micro: int,
                        opt_cfg: adamw.AdamWConfig, remat: bool,
                        accum_dtype, device: torch.device):
    from repro_torch.launch.input_specs import abstract_params
    from repro_torch.models import sharding as S
    specs = S.param_specs(cfg, mesh, abstract_params(cfg))
    dp = S.data_axes(mesh)
    dp_total = S.axis_size(mesh, dp)
    # the data axes over which a leaf's gradient is each rank's share
    shares = [tuple(a for a in dp if a not in S.spec_axes(spec))
              for spec in tree_leaves(specs)]

    def train_step(params, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor]):
        for t in tree_leaves(params) + list(batch.values()):
            if t.device.type != device.type:
                raise ValueError(f"the sharded step runs on {device}, "
                                 f"got a tensor on {t.device}")
        # the global batch's rows, then each microbatch's share of them
        whole = {k: C.gather_rows(v, mesh, dp) for k, v in batch.items()}
        mbs = shard_batch(whole, n_micro)
        b_mb = next(iter(mbs.values())).shape[1]
        if b_mb % dp_total:
            raise ValueError(f"a microbatch of {b_mb} rows does not divide "
                             f"over the {dp_total} data ranks")
        n = b_mb // dp_total
        r = C.linear_index(mesh, dp)
        mbs = {k: v[:, r * n:(r + 1) * n] for k, v in mbs.items()}
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                             device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        with L.use_mesh(mesh, specs):
            for i in op_cost.loop(n_micro):
                live = tree_map(lambda p: p.detach().requires_grad_(),
                                params)
                loss, _ = M.train_loss(
                    live, {k: v[i] for k, v in mbs.items()}, cfg,
                    remat=remat)
                grads = torch.autograd.grad(loss, tree_leaves(live))
                with torch.no_grad():
                    for a, g in zip(tree_leaves(acc), grads):
                        a.add_(g.to(a.dtype))
                loss_sum = loss_sum + loss.detach()
                del live, loss, grads
        with torch.no_grad():
            accs = tree_leaves(acc)
            for axes in dict.fromkeys(shares):   # the same order on every rank
                idx = [i for i, s in enumerate(shares) if s == axes]
                summed = C.psum([accs[i] for i in idx], mesh, axes)
                for i, t in zip(idx, summed):
                    if t is not accs[i]:
                        accs[i].copy_(t)
            grads = tree_map(lambda g: g.float().div_(n_micro), acc)
        del acc
        params, opt_state, om = adamw.update(params, grads, opt_state,
                                             opt_cfg, specs=specs, mesh=mesh)
        return params, opt_state, {"loss": loss_sum / n_micro, **om}

    return train_step


def _serving_ctx(cfg: ModelConfig, mesh, rows_sharded: bool, device):
    """(the ambient mesh of a serving step, the check of its tensors):
    ``mesh`` with the params' specs (`sharding.param_specs`), its tensors
    on ``device``; no mesh and no check without one."""
    if mesh is None:
        return (lambda: L.use_mesh(None)), (lambda *trees: None)
    from repro_torch.launch.input_specs import abstract_params
    from repro_torch.models import sharding as S
    device = resolve_device(device)
    specs = S.param_specs(cfg, mesh, abstract_params(cfg))

    def check(*trees):
        for t in pytree.tree_leaves(trees):
            if isinstance(t, torch.Tensor) and t.device.type != device.type:
                raise ValueError(f"the sharded step runs on {device}, got "
                                 f"a tensor on {t.device}")
    return (lambda: L.use_mesh(mesh, specs, rows_sharded=rows_sharded)), \
        check


def make_prefill_step(cfg: ModelConfig, *, cache_len: int, mesh=None,
                      rows_sharded: bool = True, device="cuda"):
    """``prefill_step(params, batch) -> (last-token logits, cache)``.
    With a ``mesh``, JAX's prefill jitted with the params laid out by
    `sharding.param_specs` and the batch by `sharding.batch_specs`: each
    rank passes its blocks (on ``device``) and its rows (``rows_sharded``;
    the whole batch where the global batch does not divide over the data
    ranks, ``rows_sharded=False``) and gets the logits of its rows (its
    block of the vocabulary where that divides "model") and its blocks of
    the cache as `sharding.cache_specs` lays them out."""
    ctx, check = _serving_ctx(cfg, mesh, rows_sharded, device)

    def prefill_step(params, batch):
        check(params, batch)
        with torch.inference_mode(), ctx():
            return M.prefill(params, batch, cfg, cache_len=cache_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, mesh=None,
                     rows_sharded: bool = True, device="cuda"):
    """``decode_step(params, token, cache) -> (logits, cache)``, the cache
    donated (written in place). With a ``mesh``, JAX's decode step jitted
    with the params by `sharding.param_specs`, the token by ``P(dp,
    None)`` (each rank's rows; the whole batch with
    ``rows_sharded=False``, ``P(None, None)``) and the cache by
    `sharding.cache_specs`, each rank passing its blocks on ``device``."""
    ctx, check = _serving_ctx(cfg, mesh, rows_sharded, device)

    def decode_step(params, token, cache):
        check(params, token, cache)
        with torch.inference_mode(), ctx():
            return M.decode_step(params, token, cache, cfg)
    return decode_step


def whole_logits(logits: torch.Tensor, cfg: ModelConfig, mesh,
                 rows_sharded: bool = True) -> torch.Tensor:
    """The whole (B, S, V) logits on every rank, from a sharded serving
    step's block of them: its rows (``rows_sharded``) and its block of
    the vocabulary where that divides "model" (as `param_specs` lays out
    the output projection). ``logits`` itself without a mesh."""
    if mesh is None:
        return logits
    from repro_torch.models import sharding as S
    if "model" in S.describe(mesh).axis_names \
            and cfg.vocab % S.axis_size(mesh, "model") == 0:
        logits = C.gather_along(logits, mesh, ("model",), logits.dim() - 1)
    if rows_sharded:
        logits = C.gather_rows(logits, mesh, S.data_axes(mesh))
    return logits

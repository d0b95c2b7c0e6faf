"""Public kernel ops, dispatched on the tensor's device and the plan.

Port of `repro/kernels/ops.py`. The rule for every op:

  * a CPU tensor takes the plain version (`kernels/ref.py`,
    `fused_round.fused_round_ref`, `fused_round.fused_nested_round_ref`);
  * a CUDA tensor under a "ref" plan takes the plain version too;
  * a CUDA tensor under a "cuda" plan (or no plan) launches the kernel,
    or raises. Nothing gives way to the plain version.

Each kernel's wrapper keeps a plain integer count of its launches in its
module, raised under `_build.launch_lock` so that launches from several
threads are all counted; `launch_counts` reads them and
`reset_launch_counts` sets them to 0, under the same lock.
`bind_kernels` builds and binds every kernel on the calling thread.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cluster_sum as _cs
from repro_torch.kernels import fused_round as _fr
from repro_torch.kernels import kmeans_assign as _ka
from repro_torch.kernels import ref
from repro_torch.kernels.plan import KernelPlan

#: kernel name -> (module, name of its launch count there)
_MODULES = {"assign_top2": (_ka, "launches"),
            "cluster_sum": (_cs, "launches"),
            "fused_nested_round": (_fr, "launches"),
            "fused_round": (_fr, "round_launches")}


def _kernel(t: torch.Tensor, plan: Optional[KernelPlan]) -> bool:
    return t.device.type == "cuda" and (plan is None
                                        or plan.backend == "cuda")


def assign_top2(x: torch.Tensor, c: torch.Tensor, *,
                plan: Optional[KernelPlan] = None):
    """(a, d1_sq, d2_sq): nearest / 2nd-nearest squared distances."""
    if _kernel(x, plan):
        return _ka.assign_top2_cuda(x.contiguous(), c.contiguous())
    return ref.assign_top2_ref(x, c)


def cluster_sum(x: torch.Tensor, a: torch.Tensor, k: int, *,
                weights: Optional[torch.Tensor] = None,
                plan: Optional[KernelPlan] = None):
    """Weighted per-cluster sums S (k, d) and counts v (k,)."""
    if _kernel(x, plan):
        return _cs.cluster_sum_cuda(
            x.contiguous(), a.contiguous(), k,
            weights=None if weights is None else weights.contiguous())
    return ref.cluster_sum_ref(x, a, k, weights=weights)


def fused_round(x: torch.Tensor, c: torch.Tensor, *,
                plan: Optional[KernelPlan] = None):
    """The one-shot dense round: (a, d1_sq, d2_sq, S, v, sse) with the
    top-2 on the partial distance (see `fused_round.fused_round_ref`)."""
    if _kernel(x, plan):
        return _fr.fused_round_cuda(x.contiguous(), c.contiguous())
    return _fr.fused_round_ref(x, c)


def fused_nested_round(x, c, a_prev, settled, d_keep, lb_keep, valid, *,
                       plan: Optional[KernelPlan] = None):
    """Assign + keep-select + delta S/v + sse in one call (see
    `fused_round`). The bound decisions (``settled``) stay with the
    caller, so the schedule cannot drift between backends."""
    args = [t.contiguous() for t in (x, c, a_prev, settled, d_keep,
                                     lb_keep, valid)]
    if _kernel(x, plan):
        return _fr.fused_nested_round_cuda(*args)
    return _fr.fused_nested_round_ref(*args)


def launch_counts() -> Dict[str, int]:
    """Launches of each CUDA kernel since the last reset."""
    with _build.launch_lock:
        return {name: getattr(mod, attr)
                for name, (mod, attr) in _MODULES.items()}


def reset_launch_counts() -> None:
    with _build.launch_lock:
        for mod, attr in _MODULES.values():
            setattr(mod, attr, 0)


def bind_kernels() -> None:
    """Build (where stale), load and bind every kernel's entry points on
    the calling thread, so that threads which launch them later find them
    ready: the wrappers' binders are cached without a lock."""
    for entry in _ka._ENTRY.values():
        _ka._fn(entry)
    _cs._fn()
    _fr._fn()
    _fr._round_fn()

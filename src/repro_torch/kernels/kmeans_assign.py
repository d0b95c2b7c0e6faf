"""Nearest / second-nearest centroid search: the CUDA kernel's wrapper.

Port of `repro/kernels/kmeans_assign.py::assign_top2_pallas`; the kernel
is ``csrc/assign_top2.cu`` (in f32 the tensor-core top-2 of
``csrc/tc_top2.cuh``) and its plain version `ref.assign_top2_ref`.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build, fused_round

#: launches of the CUDA kernel in this process
launches = 0

_ENTRY = {torch.float32: "assign_top2_f32", torch.bfloat16: "assign_top2_bf16"}
#: pointer and int arguments of each entry point (before the stream)
_ARITY = {"assign_top2_f32": (8, 3), "assign_top2_bf16": (6, 3)}


@functools.lru_cache(maxsize=None)
def _fn(entry: str):
    return _build.bind("assign_top2", entry, *_ARITY[entry])


def assign_top2_cuda(x: torch.Tensor, c: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(a int32, d1, d2 f32 squared) for x (n, d) and c (k, d) on the card.
    Deterministic: the same inputs give the same bits.

    x and c are both f32 or both bf16. f32 takes the tensor-core top-2
    (``csrc/tc_top2.cuh``, 3xTF32, its EPI_FULL epilogue) on copies of x
    and c zero-padded to a multiple of 4 features where d % 4 != 0
    (`fused_round.tma_operands`); bf16 the CUDA-core kernel of
    ``csrc/assign_top2.cu`` with f32 accumulation.
    """
    global launches
    dev = _build.require_cuda(x, c)
    if x.dtype not in _ENTRY or c.dtype != x.dtype:
        raise TypeError(f"assign_top2 takes f32 or bf16 x and c of one "
                        f"dtype, got {x.dtype} and {c.dtype}")
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1] \
            or c.shape[0] < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, c "
                         f"{tuple(c.shape)}")
    n, d = x.shape
    k = c.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"n={n} must fit the kernel's int sizes")
    a = torch.empty(n, dtype=torch.int32, device=dev)
    d1 = torch.empty(n, dtype=torch.float32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return a, d1, d2
    entry = _ENTRY[x.dtype]
    if x.dtype == torch.float32:
        xp, cp, dp = fused_round.tma_aligned(x, c)
        c_split, cn = fused_round.tc_scratch(k, dp, dev)
        err = _fn(entry)(xp.data_ptr(), cp.data_ptr(), c_split[0].data_ptr(),
                         c_split[1].data_ptr(), cn.data_ptr(), a.data_ptr(),
                         d1.data_ptr(), d2.data_ptr(), n, k, dp,
                         _build.stream(dev))
    else:
        cn = torch.empty(k, dtype=torch.float32, device=dev)
        err = _fn(entry)(x.data_ptr(), c.data_ptr(), cn.data_ptr(),
                         a.data_ptr(), d1.data_ptr(), d2.data_ptr(),
                         n, k, d, _build.stream(dev))
    _build.check(err, "assign_top2", entry)
    launches += 1
    return a, d1, d2

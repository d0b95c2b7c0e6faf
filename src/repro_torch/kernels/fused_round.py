"""The fused rounds: the CUDA kernels' wrappers and their plain versions.

Port of `repro/kernels/fused_round.py`:

* `fused_round_pallas`, the one-shot dense round (kernel
  ``csrc/fused_round.cu``, its top-2 on the tensor cores in
  ``csrc/tc_top2.cuh``; plain version `fused_round_ref`). It takes x
  (n, d) and c (k, d) and returns (a, d1, d2, S, v, sse): the nearest and
  second-nearest centroid, as squared distances, and the per-cluster
  sums, counts and sum of d1 over every row.
* `fused_nested_round_pallas` (kernel ``csrc/fused_nested_round.cu``,
  its top-2 on the tensor cores in ``csrc/tc_top2.cuh``; plain version
  `fused_nested_round_ref`). It takes the prefix x (b, d),
  the centroids c (k, d), the previous assignment a_prev (b,) int32, the
  caller's ``settled`` mask, the retained euclidean distance ``d_keep``
  and decayed lower bound ``lb_keep`` of the settled rows, and the
  ``valid`` row mask, and returns (a_new, d_new, lb_new, dS, dv, sse):
  -1 / 0 / 0 on invalid rows, the signed delta of the cluster sums and
  counts (+1 at a_new for joins and new rows, -1 at a_prev for leaves),
  and the per-cluster sum of d_new^2 over every valid row.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.cluster_sum import scatter_scratch

#: launches of the nested round's CUDA kernel in this process
launches = 0
#: launches of the one-shot round's CUDA kernel in this process
round_launches = 0


@functools.lru_cache(maxsize=None)
def _fn():
    return _build.bind("fused_nested_round", "fused_nested_round_f32", 17, 5)


@functools.lru_cache(maxsize=None)
def _round_fn():
    return _build.bind("fused_round", "fused_round_f32", 13, 5)


@functools.lru_cache(maxsize=None)
def _dot_fn():
    return _build.bind("fused_round", "tc_dot_f32", 6, 3)


def tma_operands(x: torch.Tensor, c: torch.Tensor):
    """(x, c, dp): x (n, d) and c (k, d) as the tensor-core top-2 reads
    them, rows of dp floats with dp a multiple of 4 (TMA reads rows whose
    stride is a multiple of 16 bytes) and at least 4. Where d % 4 != 0
    (or d == 0) they are copied, zero-padded to dp; zero features change
    no distance. Otherwise they are returned as they are."""
    d = x.shape[1]
    dp = max(4, -(-d // 4) * 4)
    if dp != d:
        x = torch.nn.functional.pad(x, (0, dp - d))
        c = torch.nn.functional.pad(c, (0, dp - d))
    return x, c, dp


def tma_aligned(x: torch.Tensor, c: torch.Tensor):
    """`tma_operands`, checked: the TMA loads of the tensor-core top-2
    take x and c at 16-byte aligned addresses. A fresh tensor is, and so
    is any view that starts at a row of a tensor whose rows hold a
    multiple of 4 floats (``X[:b]``, ``X[idx]``'s copy)."""
    xp, cp, dp = tma_operands(x, c)
    if xp.data_ptr() % 16 or cp.data_ptr() % 16:
        raise ValueError("the tensor-core top-2's TMA loads take x and c "
                         "at 16-byte aligned addresses")
    return xp, cp, dp


def tc_scratch(k: int, dp: int, device):
    """The tensor-core top-2's scratch: c's TF32 big and small halves
    (2, k, dp) and |c|^2 (k,)."""
    return (torch.empty(2, k, dp, dtype=torch.float32, device=device),
            torch.empty(k, dtype=torch.float32, device=device))


def _check_round_args(x: torch.Tensor, c: torch.Tensor):
    dev = _build.require_cuda(x, c)
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"fused_round takes f32 x and c, got {x.dtype} and "
                        f"{c.dtype}")
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1] \
            or c.shape[0] < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)}, c "
                         f"{tuple(c.shape)}")
    n, d = x.shape
    k = c.shape[0]
    if n >= 2 ** 31 or k * d + 2 * k >= 2 ** 31:
        raise ValueError(f"n={n} and k*d + 2k = {k * d + 2 * k} must fit "
                         f"the kernel's int sizes")
    return (dev,) + tma_aligned(x, c)


def fused_round_cuda(x: torch.Tensor, c: torch.Tensor):
    """The one-shot round on the card: (a int32, d1, d2 f32 squared, S
    (k, d), v (k,), sse (k,)) for f32 x (n, d) and c (k, d).
    Deterministic: the same inputs give the same bits.

    The top-2 runs on the tensor cores in 3xTF32 (``csrc/tc_top2.cuh``).
    Where d % 4 != 0 it reads copies of x and c zero-padded to a multiple
    of 4 features (`tma_operands`); the sums always read x itself."""
    global round_launches
    dev, xp, cp, dp = _check_round_args(x, c)
    n, d = x.shape
    k = c.shape[0]
    a = torch.empty(n, dtype=torch.int32, device=dev)
    d1 = torch.empty(n, dtype=torch.float32, device=dev)
    d2 = torch.empty(n, dtype=torch.float32, device=dev)
    out = torch.zeros(k * d + 2 * k, dtype=torch.float32, device=dev)
    if n > 0:
        c_split, cn = tc_scratch(k, dp, dev)
        xn = torch.empty(n, dtype=torch.float32, device=dev)
        rows, partial, lists = scatter_scratch(n, k, d, 2, 1, dev)
        err = _round_fn()(x.data_ptr(), xp.data_ptr(), cp.data_ptr(),
                          c_split[0].data_ptr(), c_split[1].data_ptr(),
                          cn.data_ptr(), xn.data_ptr(), a.data_ptr(),
                          d1.data_ptr(), d2.data_ptr(), partial.data_ptr(),
                          lists.data_ptr(), out.data_ptr(), n, k, d, dp,
                          rows, _build.stream(dev))
        _build.check(err, "fused_round", "fused_round_f32")
        with _build.launch_lock:
            round_launches += 1
    kd = k * d
    return (a, d1, d2, out[:kd].view(k, d), out[kd:kd + k],
            out[kd + k:])


def tc_dot_cuda(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x @ c.T (n, k) f32 through the tensor-core top-2's main loop alone
    (TMA, 3xTF32 split, wgmma), written out instead of reduced: a check of
    its operand and fragment layout. Not on any path; counts no launch."""
    dev, xp, cp, dp = _check_round_args(x, c)
    n, k = x.shape[0], c.shape[0]
    dot = torch.empty(n, k, dtype=torch.float32, device=dev)
    if n > 0:
        c_split, cn = tc_scratch(k, dp, dev)
        err = _dot_fn()(xp.data_ptr(), cp.data_ptr(), c_split[0].data_ptr(),
                        c_split[1].data_ptr(), cn.data_ptr(), dot.data_ptr(),
                        n, k, dp, _build.stream(dev))
        _build.check(err, "fused_round", "tc_dot_f32")
    return dot


def fused_round_ref(x: torch.Tensor, c: torch.Tensor):
    """Plain version, with the kernel's arithmetic: the top-2 on the
    partial distance ``|c|^2 - 2 x.c`` (the lower index wins a tie; a
    duplicate of the min counts as the 2nd-min; k == 1 gives +inf), then
    ``d = max(b + |x|^2, 0)`` for the two winners, and S, v, sse summed
    by label over every row.

    All in f32. The kernel's x.c (3xTF32 on the tensor cores, compensated
    sums) is nearer the exact value than this f32 product where |x|^2
    and x.c cancel, as at kmeans_xl width, so the checks on the card
    hold the kernel's top-2 to x.c, |x|^2 and |c|^2 taken in float64
    and rounded once to f32.

    Where it differs from JAX's `fused_round_ref`: that one takes the
    top-2 on the ref expression ``max(|x|^2 - 2 x.c + |c|^2, 0)``, as
    `ref.assign_top2_ref` does, which rounds differently at ties and in
    the last bits of d1 and d2. This one follows `_round_kernel`, the
    TPU kernel itself.
    """
    x = x.float()
    c = c.float()
    k = c.shape[0]
    xn = torch.einsum("nd,nd->n", x, x)
    cn = torch.einsum("kd,kd->k", c, c)
    pd = torch.mm(x, c.T).mul_(-2.0).add_(cn)        # (n, k), in place
    a = torch.argmin(pd, dim=1)
    b1 = torch.gather(pd, 1, a[:, None])[:, 0]
    if k == 1:
        b2 = torch.full_like(b1, float("inf"))
    else:
        b2 = torch.min(pd.scatter_(1, a[:, None], float("inf")),
                       dim=1).values
    del pd
    d1 = torch.clamp_min(b1 + xn, 0.0)
    d2 = torch.clamp_min(b2 + xn, 0.0)
    S, v = ref.cluster_sum_ref(x, a, k)
    _, sse = ref.cluster_sum_ref(x[:, :0], a, k, weights=d1)
    return a.to(torch.int32), d1, d2, S, v, sse


def fused_nested_round_cuda(x, c, a_prev, settled, d_keep, lb_keep, valid):
    """The fused round on the card (f32 x and c; bool masks).
    Deterministic: the same inputs give the same bits.

    The top-2 runs on the tensor cores in 3xTF32 (``csrc/tc_top2.cuh``,
    its EPI_NESTED epilogue), on copies of x and c zero-padded to a
    multiple of 4 features where d % 4 != 0 (`tma_operands`); the sums
    read x itself."""
    global launches
    dev = _build.require_cuda(x, c, a_prev, settled, d_keep, lb_keep, valid)
    if x.dtype != torch.float32 or c.dtype != torch.float32 \
            or a_prev.dtype != torch.int32 \
            or settled.dtype != torch.bool or valid.dtype != torch.bool \
            or d_keep.dtype != torch.float32 \
            or lb_keep.dtype != torch.float32:
        raise TypeError("fused_nested_round takes f32 x, c, d_keep, "
                        "lb_keep, int32 a_prev and bool settled, valid")
    n, d = x.shape
    k = c.shape[0]
    if c.shape != (k, d) or k < 1 or any(
            t.shape != (n,) for t in (a_prev, settled, d_keep, lb_keep,
                                      valid)):
        raise ValueError(f"bad shapes x {tuple(x.shape)}, c "
                         f"{tuple(c.shape)}")
    if n >= 2 ** 31 or k * d + 2 * k >= 2 ** 31:
        raise ValueError(f"n={n} and k*d + 2k = {k * d + 2 * k} must fit "
                         f"the kernel's int sizes")
    xp, cp, dp = tma_aligned(x, c)
    a_new = torch.empty(n, dtype=torch.int32, device=dev)
    d_new = torch.empty(n, dtype=torch.float32, device=dev)
    lb_new = torch.empty(n, dtype=torch.float32, device=dev)
    out = torch.zeros(k * d + 2 * k, dtype=torch.float32, device=dev)
    if n > 0:
        c_split, cn = tc_scratch(k, dp, dev)
        rows, partial, lists = scatter_scratch(n, k, d, 2, 2, dev)
        err = _fn()(x.data_ptr(), xp.data_ptr(), cp.data_ptr(),
                    c_split[0].data_ptr(), c_split[1].data_ptr(),
                    cn.data_ptr(), a_prev.data_ptr(), settled.data_ptr(),
                    d_keep.data_ptr(), lb_keep.data_ptr(), valid.data_ptr(),
                    a_new.data_ptr(), d_new.data_ptr(), lb_new.data_ptr(),
                    partial.data_ptr(), lists.data_ptr(), out.data_ptr(),
                    n, k, d, dp, rows, _build.stream(dev))
        _build.check(err, "fused_nested_round", "fused_nested_round_f32")
        with _build.launch_lock:
            launches += 1
    kd = k * d
    return (a_new, d_new, lb_new, out[:kd].view(k, d), out[kd:kd + k],
            out[kd + k:])


def fused_nested_round_ref(x, c, a_prev, settled, d_keep, lb_keep, valid):
    """Plain version, op for op the unfused round path."""
    k = c.shape[0]
    af, d1sq, d2sq = ref.assign_top2_ref(x, c)
    d1 = torch.sqrt(torch.clamp_min(d1sq, 0.0))
    d2 = torch.sqrt(torch.clamp_min(d2sq, 0.0))
    settled = settled.bool()
    valid = valid.bool()
    minus1 = torch.full_like(af, -1)
    zero = torch.zeros_like(d1)
    a_new = torch.where(valid, torch.where(settled, a_prev, af), minus1)
    d_new = torch.where(valid, torch.where(settled, d_keep, d1), zero)
    lb_new = torch.where(valid, torch.where(settled, lb_keep, d2), zero)
    return (a_new, d_new, lb_new) + delta_sums(x, a_prev, a_new, d_new, k)


def delta_sums(x, a_prev, a_new, d_new, k: int):
    """(dS, dv, sse) of a nested round, plain: +x at a_new for joins and
    new rows, -x at a_prev for leaves, d_new^2 at a_new for every row."""
    seen = a_prev >= 0
    changed = seen & (a_new != a_prev)
    w_rm = changed.float()
    w_add = ((changed | ~seen) & (a_new >= 0)).float()
    S_rm, v_rm = ref.cluster_sum_ref(x, a_prev.clamp(0, k - 1), k,
                                     weights=w_rm)
    S_add, v_add = ref.cluster_sum_ref(x, a_new.clamp(0, k - 1), k,
                                       weights=w_add)
    _, sse = ref.cluster_sum_ref(x[:, :0], a_new.clamp(0, k - 1), k,
                                 weights=d_new * d_new)
    return S_add - S_rm, v_add - v_rm, sse

"""Collectives over the named dims of a `DeviceMesh`: the port's
`jax.lax.psum`, `psum_scatter`, `pmax`, `pmin`, `all_gather`, `ppermute`
(one step of the ring, `ppermute_ring`) and `axis_index`, and the
all-gather that replicates a row-sharded array (`gather_rows`).

Inside JAX's ``shard_map`` a round names mesh axes; here a round takes
the `DeviceMesh` and the names, and each collective runs over the
process group of each named dim (`DeviceMesh.get_group`). Every rank
runs the same collectives in the same order. ``mesh=None`` is the
single-device form: each collective is the identity, as over a
one-device mesh. Over a dim of one rank each is the identity too, as in
JAX, and calls no backend (a one-rank NCCL or gloo call returns the
same bits at a host cost).

A gloo group carries CUDA tensors itself in every collective used here
(all-reduce with SUM, MAX and MIN, all-gather, reduce-scatter and
all-to-all; torch 2.11 on an H100), staging them through the host, so
the same calls serve ranks on the CPU, ranks that share one card under
gloo, and ranks on their own cards under NCCL. Its send and receive do
not ("Bad address" from its TCP pair), and none is used. A collective
that fails raises.

A gloo collective of a CUDA tensor copies it through the host, and so
waits for the stream, where NCCL's (and JAX's in-graph collectives) do
not. Each such call runs inside the scopes that `STAGING_HOOKS` holds
(none but while a host-sync audit is installed,
`repro_torch.analysis.hostsync`), and only such a call: on CPU tensors,
under NCCL and over a dim of one rank no scope is opened.
"""
from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


#: factories of the scopes entered around a collective that gloo stages
#: through the host (a CUDA tensor on a gloo group)
STAGING_HOOKS: List[Callable[[], ContextManager]] = []


def _staged(t: torch.Tensor, group):
    """The scope of one collective of ``t`` on ``group``: every hook's
    scope where gloo carries a CUDA tensor, else none."""
    if not (STAGING_HOOKS and t.is_cuda
            and dist.get_backend(group) == "gloo"):
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    for hook in STAGING_HOOKS:
        stack.enter_context(hook())
    return stack


def axis_size(mesh, axis: str) -> int:
    """Ranks along the named dim (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along the named dim (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def linear_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index, row-major over the named dims."""
    idx = 0
    for ax in axes:
        idx = idx * axis_size(mesh, ax) + axis_index(mesh, ax)
    return idx


def psum(tensors: Sequence[torch.Tensor], mesh: Optional[object],
         axes: Sequence[str]) -> Tuple[torch.Tensor, ...]:
    """Each tensor summed over every rank of the named dims; every rank
    gets the same bits.

    The floats travel as one f32 buffer and the integers and bools as one
    int64 buffer, so a count is exact beyond f32's 2^24 and a bool (which
    NCCL cannot reduce) comes back as "any". Each tensor keeps its dtype
    and shape.
    """
    tensors = tuple(tensors)
    axes = [ax for ax in axes if axis_size(mesh, ax) > 1]
    if not axes:
        return tensors
    out = list(tensors)
    floats = [i for i, t in enumerate(tensors) if t.is_floating_point()]
    ints = [i for i, t in enumerate(tensors) if not t.is_floating_point()]
    for idx, wire in ((floats, torch.float32), (ints, torch.int64)):
        if not idx:
            continue
        flat = torch.cat([tensors[i].reshape(-1).to(wire) for i in idx])
        for ax in axes:
            group = mesh.get_group(ax)
            with _staged(flat, group):
                dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            t = tensors[i]
            out[i] = flat[off:off + t.numel()].view(t.shape).to(t.dtype)
            off += t.numel()
    return tuple(out)


def all_gather(t: torch.Tensor, mesh: Optional[object],
               axis: str) -> torch.Tensor:
    """(m, *t.shape): ``t`` of every rank along the named dim, in
    coordinate order."""
    if axis_size(mesh, axis) == 1:
        return t[None]
    group = mesh.get_group(axis)
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
    with _staged(t, group):
        dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def gather_rows(t: torch.Tensor, mesh: Optional[object],
                axes: Sequence[str]) -> torch.Tensor:
    """The rows of ``t`` of every rank of the named dims, concatenated
    in rank order (row-major over ``axes``, the order in which
    ``P(axes)`` slices a global array): a row-sharded array made whole
    on every rank."""
    if mesh is None:
        return t
    for ax in reversed(tuple(axes)):
        t = all_gather(t, mesh, ax)
        t = t.reshape((-1,) + t.shape[2:])
    return t


def psum_scatter(t: torch.Tensor, mesh: Optional[object],
                 axis: str) -> torch.Tensor:
    """``t`` summed over the ranks of the named dim and scattered along
    dim 0: rank i gets rows [i * n / m, (i + 1) * n / m) of the sum
    (JAX's ``psum_scatter(t, axis, scatter_dimension=0, tiled=True)``).
    The rows must divide evenly over the dim."""
    m = axis_size(mesh, axis)
    if m == 1:
        return t
    if t.shape[0] % m:
        raise ValueError(f"{t.shape[0]} rows do not scatter over {m} ranks")
    out = t.new_empty((t.shape[0] // m,) + tuple(t.shape[1:]))
    group = mesh.get_group(axis)
    with _staged(t, group):
        dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def _preduce(t: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    if axis_size(mesh, axis) == 1:
        return t
    out = t.clone(memory_format=torch.contiguous_format)
    group = mesh.get_group(axis)
    with _staged(out, group):
        dist.all_reduce(out, op=op, group=group)
    return out


def pmax(t: torch.Tensor, mesh: Optional[object], axis: str) -> torch.Tensor:
    """The elementwise maximum of ``t`` over the ranks of the named dim
    (exact, so every rank gets the same bits)."""
    return _preduce(t, mesh, axis, dist.ReduceOp.MAX)


def pmin(t: torch.Tensor, mesh: Optional[object], axis: str) -> torch.Tensor:
    """The elementwise minimum of ``t`` over the ranks of the named
    dim."""
    return _preduce(t, mesh, axis, dist.ReduceOp.MIN)


def ppermute_ring(t: torch.Tensor, mesh: Optional[object],
                  axis: str) -> torch.Tensor:
    """One step of the ring ``i -> i + 1 mod m`` along the named dim: the
    ``t`` of the rank before this one (JAX's ``ppermute`` with
    ``perm=[(i, (i + 1) % m) for i in range(m)]``). The identity at one
    rank.

    An all-to-all whose only nonempty split goes to the next rank: a
    collective, ordered as the group's others are, and each rank holds
    two blocks, never m. (Not ``batch_isend_irecv``: gloo's sends cannot
    take CUDA tensors, and on the CPU a ring of them beside gloo's
    reduce-scatters hung two ranks within 21 steps.)
    """
    m = axis_size(mesh, axis)
    if m == 1:
        return t
    i = axis_index(mesh, axis)
    send = t.contiguous()
    recv = torch.empty_like(send)
    n = send.shape[0]
    group = mesh.get_group(axis)
    with _staged(send, group):
        dist.all_to_all_single(
            recv, send, output_split_sizes=[n * (r == (i - 1) % m)
                                            for r in range(m)],
            input_split_sizes=[n * (r == (i + 1) % m) for r in range(m)],
            group=group)
    return recv


# --------------------------------------------------------------------------
# differentiable forms, for the sharded model (repro_torch.models.layers)
# --------------------------------------------------------------------------
#
# Inside JAX's ``shard_map`` and under GSPMD each collective has a
# transpose; here each is a `torch.autograd.Function` whose backward is
# that transpose, run by every rank in the same order (the backward's
# order is the graph's). Over a dim of one rank each returns its input
# itself, so a one-rank mesh runs exactly the single-device ops.

def _movedim_op(op, t: torch.Tensor, dim: int) -> torch.Tensor:
    return op(t.movedim(dim, 0).contiguous()).movedim(0, dim).contiguous()


def gather_along(t: torch.Tensor, mesh, axes: Sequence[str],
                 dim: int) -> torch.Tensor:
    """`gather_rows` along ``dim``: the blocks of every rank of the named
    dims put together there, row-major over ``axes``. 16-bit floats
    travel as f32 (exact; gloo gathers no 16-bit type)."""
    wire = (torch.float32 if t.dtype in (torch.bfloat16, torch.float16)
            else t.dtype)
    return _movedim_op(lambda u: gather_rows(u, mesh, axes),
                       t.to(wire), dim).to(t.dtype)


def _gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return gather_along(t, mesh, (axis,), dim)


def _scatter_sum(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    # summed in f32, as `psum` sums
    out = _movedim_op(lambda u: psum_scatter(u, mesh, axis), t.float(), dim)
    return out.to(t.dtype)


def _own(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    m = axis_size(mesh, axis)
    n = t.shape[dim] // m
    return t.narrow(dim, axis_index(mesh, axis) * n, n).contiguous()


class _SumFwd(torch.autograd.Function):
    """psum forward; the cotangent passes unchanged (each rank's share of
    a sum that every rank then uses whole)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return psum([t], mesh, [axis])[0]

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumBwd(torch.autograd.Function):
    """Identity forward; psum of the cotangent (a whole value entering a
    region where each rank computes a share)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return psum([g], ctx.mesh, [ctx.axis])[0], None, None


class _SumBoth(torch.autograd.Function):
    """psum forward and backward: a sum whose result each rank uses for
    its own share."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return psum([t], mesh, [axis])[0]

    @staticmethod
    def backward(ctx, g):
        return psum([g], ctx.mesh, [ctx.axis])[0], None, None


class _GatherScatter(torch.autograd.Function):
    """All-gather along ``dim`` forward; the cotangent summed over the
    ranks and scattered back along ``dim`` (FSDP's weight gather)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Split(torch.autograd.Function):
    """This rank's block along ``dim`` forward; the blocks' cotangents
    all-gathered back (a whole value split over the ranks)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _own(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


class _Unsplit(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's block of the
    cotangent back (blocks put together into a value every rank uses
    whole)."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather(t, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.mesh, ctx.axis, ctx.dim), None, None, None


def _one(mesh, axis) -> bool:
    return mesh is None or axis_size(mesh, axis) == 1


def sum_over(t, mesh, axis: str):
    """``t`` summed over the named dim (f32 on the wire); its cotangent
    passes through unchanged."""
    return t if _one(mesh, axis) else _SumFwd.apply(t, mesh, axis)


def sum_grad_over(t, mesh, axis: str):
    """``t`` itself; its cotangent summed over the named dim."""
    return t if _one(mesh, axis) else _SumBwd.apply(t, mesh, axis)


def sum_both_over(t, mesh, axis: str):
    """``t`` summed over the named dim, and its cotangent too."""
    return t if _one(mesh, axis) else _SumBoth.apply(t, mesh, axis)


def gather_over(t, mesh, axis: str, dim: int):
    """The blocks of every rank along the named dim put together along
    ``dim``; the cotangent reduce-scattered back (f32 sums)."""
    return t if _one(mesh, axis) else _GatherScatter.apply(t, mesh, axis, dim)


def split_over(t, mesh, axis: str, dim: int):
    """This rank's block of ``t`` along ``dim``; the cotangent
    all-gathered."""
    return t if _one(mesh, axis) else _Split.apply(t, mesh, axis, dim)


def unsplit_over(t, mesh, axis: str, dim: int):
    """The blocks of every rank put together along ``dim``; the
    cotangent's own block back."""
    return t if _one(mesh, axis) else _Unsplit.apply(t, mesh, axis, dim)

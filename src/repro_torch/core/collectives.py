"""Collectives over the named dims of a `DeviceMesh`: the port's
`jax.lax.psum`, `jax.lax.all_gather` and `jax.lax.axis_index`, and the
all-gather that replicates a row-sharded array (`gather_rows`).

Inside JAX's ``shard_map`` a round names mesh axes; here a round takes
the `DeviceMesh` and the names, and each collective runs over the
process group of each named dim (`DeviceMesh.get_group`). Every rank
runs the same collectives in the same order. ``mesh=None`` is the
single-device form: each collective is the identity, as over a
one-device mesh.

A gloo group carries CUDA tensors itself (its all-reduce and all-gather
stage them through the host), so the same calls serve ranks on the CPU,
ranks that share one card under gloo, and ranks on their own cards under
NCCL.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


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
    if mesh is None or not axes:
        return tensors
    out = list(tensors)
    floats = [i for i, t in enumerate(tensors) if t.is_floating_point()]
    ints = [i for i, t in enumerate(tensors) if not t.is_floating_point()]
    for idx, wire in ((floats, torch.float32), (ints, torch.int64)):
        if not idx:
            continue
        flat = torch.cat([tensors[i].reshape(-1).to(wire) for i in idx])
        for ax in axes:
            dist.all_reduce(flat, group=mesh.get_group(ax))
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
    if mesh is None:
        return t[None]
    group = mesh.get_group(axis)
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh, axis))]
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

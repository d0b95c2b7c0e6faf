"""Device meshes and process groups for the port's sharded engines.

Port of `repro/launch/mesh.py`. The port's mesh is a
`torch.distributed.device_mesh.DeviceMesh`, one process per device as is
usual in torch, whose ``mesh_dim_names`` are the JAX axis names
("data", "model", ...). It is built once a process group is up: either
the caller runs `torch.distributed.init_process_group` with its own
address, world size and rank, or `initialize_multihost` does it from a
`FitConfig`'s coordinator fields. Nothing here discovers a cluster.

The group's backend follows the device: NCCL on the card, gloo on the
CPU. Under NCCL every rank computes on its own card (`rank_device`).
Under gloo the ranks compute where the caller puts them: on the CPU for
the tests, or all on one card, whose tensors gloo carries through the
host itself (the all-reduce and all-gather of CUDA tensors).

FUNCTIONS only: importing this module touches no process group.
"""
from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_host_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model")) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the process group, ranks in
    row-major order, with dims named ``axes``: a flat ``("data",)`` mesh
    for the mesh engine, a ``("data", "model")`` one for the XL engine
    (a one-rank NCCL group builds the (1, 1) mesh of a one-card XL fit).
    A process group may hold several meshes of its ranks at once."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the process group has {dist.get_world_size()}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 single-pod (256 ranks) over ("data", "model"), or 2x16x16
    two-pod (512 ranks) over ("pod", "data", "model"), from the process
    group, which must hold that many ranks (a real one, or the fake group
    of `init_fake_group` for the dry run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_host_mesh(shape, axes)


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake process group of
    ``world_size`` ranks (`torch.testing._internal.distributed.fake_pg`):
    its collectives return at once and move nothing. For analysis only
    (the dry run traces one rank's step over it on fake tensors); a step
    run on real tensors over it computes nothing right. Tears down a
    group already up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=int(rank),
                            world_size=int(world_size))


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on.

    Under an NCCL group, ``cuda:{local rank}`` (``LOCAL_RANK``, else the
    rank modulo the cards in view), made the current device, since NCCL
    refuses two ranks on one card; ``device`` must then be a CUDA
    device. Otherwise ``device`` as given.
    """
    dev = torch.device(device)
    if dist.is_initialized() and dist.get_backend() == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"an NCCL group computes on the card, got "
                             f"device={str(device)!r}")
        local = int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return dev


# --------------------------------------------------------------------------
# multi-process groups from a FitConfig's coordinator fields
# --------------------------------------------------------------------------

def distributed_initialized() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize_multihost(*, coordinator_address: str, num_processes: int,
                         process_id: int, device="cuda") -> None:
    """Join the process group of ``num_processes`` ranks that meet at
    ``coordinator_address`` ("host:port", where rank 0 listens), as rank
    ``process_id``: NCCL when ``device`` is a card, gloo on the CPU. A
    development cluster is N local processes pointed at one localhost
    port. No-op when the group is already up."""
    if distributed_initialized():
        return
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def ensure_multihost_initialized(config, device="cuda") -> None:
    """Join the group named by a `FitConfig`'s coordinator fields (no-op
    when they are unset or the group is already up)."""
    if config.coordinator_address is None:
        return
    initialize_multihost(coordinator_address=config.coordinator_address,
                         num_processes=config.num_processes,
                         process_id=config.process_id, device=device)


def make_multihost_mesh(data_axes=("data",)) -> DeviceMesh:
    """One flat data dim over EVERY rank of the process group.

    The multihost engine row-shards points over this mesh and keeps the
    cluster stats replicated; with one rank this is exactly the mesh
    engine's one-rank layout, which makes the two bit-identical there.
    """
    data_axes = tuple(data_axes)
    if len(data_axes) != 1:
        raise ValueError(
            f"make_multihost_mesh builds one flat data axis; got "
            f"data_axes={data_axes!r} (pass a mesh to MultiHostEngine "
            f"for multi-axis layouts)")
    if not distributed_initialized():
        raise RuntimeError(
            "backend='multihost' needs a process group: set the config's "
            "coordinator_address, num_processes and process_id, or call "
            "torch.distributed.init_process_group first")
    return make_host_mesh((dist.get_world_size(),), data_axes)

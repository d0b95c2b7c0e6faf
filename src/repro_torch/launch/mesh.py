"""Device meshes for the port's sharded rounds.

Port of `repro/launch/mesh.py::make_host_mesh`. The port's mesh is a
`torch.distributed.device_mesh.DeviceMesh`, one process per device as is
usual in torch, whose ``mesh_dim_names`` are the JAX axis names
("data", "model", ...). It is built once a process group is up: the
caller runs `torch.distributed.init_process_group` with its own address,
world size and rank; nothing here discovers a cluster. The mesh lies on
"cuda" under an NCCL group and on "cpu" under gloo.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_host_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model")) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the process group, ranks in
    row-major order, with dims named ``axes``."""
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

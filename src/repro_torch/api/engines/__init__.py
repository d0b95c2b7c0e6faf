"""Execution engines of the port: one module per backend, one contract
(`base`).

  local      single process, one device
  mesh       one rank per process over a `DeviceMesh`; points
             row-sharded, stats replicated
  multihost  the mesh engine over a process group it joins from the
             config's coordinator fields

All are driven by the ONE host loop in `repro_torch.api.loop`;
`make_engine` maps `FitConfig.backend` to the right one. The xl engine
(centroids sharded over the model dim) is ROADMAP Queue 1 item 9 step 2.
"""
from __future__ import annotations

from repro_torch.api.config import FitConfig
from repro_torch.api.engines.base import Engine, EngineRun
from repro_torch.api.engines.local import LocalEngine
from repro_torch.api.engines.mesh import MeshEngine
from repro_torch.api.engines.multihost import MultiHostEngine

__all__ = ["Engine", "EngineRun", "LocalEngine", "MeshEngine",
           "MultiHostEngine", "make_engine"]


def make_engine(config: FitConfig, *, mesh=None) -> Engine:
    """Engine for ``config.backend`` ("mesh" needs a mesh; "multihost"
    builds one over every rank of its process group when omitted)."""
    if config.backend == "xl":
        raise NotImplementedError(
            "backend='xl' is not ported to repro_torch yet (ROADMAP "
            "Queue 1 item 9 step 2)")
    if config.backend == "mesh":
        if mesh is None:
            raise ValueError(
                "backend='mesh' needs a torch.distributed DeviceMesh "
                "(repro_torch.launch.mesh.make_host_mesh)")
        return MeshEngine(mesh)
    if config.backend == "multihost":
        return MultiHostEngine(mesh)
    return LocalEngine()

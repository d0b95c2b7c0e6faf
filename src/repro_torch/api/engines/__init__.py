"""Execution engines of the port: one module per backend, one contract
(`base`).

  local      single process, one device
  mesh       one rank per process over a `DeviceMesh`; points
             row-sharded, stats replicated
  xl         the mesh engine with the stats also sharded over the
             model dim of a (data, model) `DeviceMesh`
  multihost  the mesh engine over a process group it joins from the
             config's coordinator fields

All are driven by the ONE host loop in `repro_torch.api.loop`;
`make_engine` maps `FitConfig.backend` to the right one.
"""
from __future__ import annotations

from repro_torch.api.config import FitConfig
from repro_torch.api.engines.base import Engine, EngineRun
from repro_torch.api.engines.local import LocalEngine
from repro_torch.api.engines.mesh import MeshEngine
from repro_torch.api.engines.multihost import MultiHostEngine
from repro_torch.api.engines.xl import XLEngine

__all__ = ["Engine", "EngineRun", "LocalEngine", "MeshEngine",
           "MultiHostEngine", "XLEngine", "make_engine"]


def make_engine(config: FitConfig, *, mesh=None) -> Engine:
    """Engine for ``config.backend`` ("mesh" and "xl" need a mesh, xl's
    with the config's model dim; "multihost" builds one over every rank
    of its process group when omitted)."""
    if config.backend in ("mesh", "xl"):
        if mesh is None:
            raise ValueError(
                f"backend={config.backend!r} needs a torch.distributed "
                f"DeviceMesh (repro_torch.launch.mesh.make_host_mesh)")
        return XLEngine(mesh) if config.backend == "xl" else MeshEngine(mesh)
    if config.backend == "multihost":
        return MultiHostEngine(mesh)
    return LocalEngine()

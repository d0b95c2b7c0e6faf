"""Execution engines of the port: one contract (`base`), one backend
(`local`). The mesh, xl and multihost engines are ROADMAP Queue 1
item 9."""
from __future__ import annotations

from repro_torch.api.config import FitConfig
from repro_torch.api.engines.base import Engine, EngineRun
from repro_torch.api.engines.local import LocalEngine

__all__ = ["Engine", "EngineRun", "LocalEngine", "make_engine"]


def make_engine(config: FitConfig) -> Engine:
    """Engine for ``config.backend``; only "local" is ported."""
    if config.backend != "local":
        raise NotImplementedError(
            f"backend={config.backend!r} is not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item 9)")
    return LocalEngine()

"""`MultiHostEngine`: the mesh engine over a process group that it joins
itself.

Port of `repro/api/engines/multihost.py`. In JAX the mesh engine is one
process and this engine spans `jax.distributed` processes, so it owns
the per-process placement, the gathers and the coordinator's
checkpoint reads. The port's mesh engine already runs one rank per
process and does all of that (`api/engines/mesh.py`); what this engine
adds is the group: with no mesh given, `begin` joins the process group
that the config's ``coordinator_address``, ``num_processes`` and
``process_id`` name (NCCL on the card, gloo on the CPU) and builds one
flat data dim over every rank (`repro_torch.launch.mesh`). On one rank
a multihost fit places the same rows and runs the same rounds as a
one-rank mesh fit, so the two are bit-identical.
"""
from __future__ import annotations

from repro_torch.api.config import FitConfig
from repro_torch.api.engines.base import EngineRun
from repro_torch.api.engines.mesh import _MeshRun
from repro_torch.launch.mesh import (ensure_multihost_initialized,
                                     make_multihost_mesh)
from repro_torch.obs import span


class _MultiHostRun(_MeshRun):
    _engine_name = "multihost"


class MultiHostEngine:
    """The mesh schedule over every rank of a process group.

    Build one per process (the same config everywhere) and call `begin`
    with the same dataset on every process. ``mesh`` may be omitted:
    `begin` then joins the group from the config's coordinator fields
    (unless a group is already up) and builds a flat data mesh over
    every rank.
    """

    def __init__(self, mesh=None):
        self.mesh = mesh

    def begin(self, X, config: FitConfig, *, X_val=None, init_C=None,
              device="cuda") -> EngineRun:
        if self.mesh is None:
            ensure_multihost_initialized(config, device)
            self.mesh = make_multihost_mesh(config.data_axes)
        with span("engine.place"):
            return _MultiHostRun(X, config, self.mesh, X_val, init_C,
                                 device)

"""`XLEngine`: centroids sharded over the model dim (kmeans_xl scale).

Port of `repro/api/engines/xl.py`. A `_MeshRun` whose cluster stats are
sharded over ``config.model_axis`` of a ``(data, model)`` `DeviceMesh`,
one rank per process: NCCL on the card, gloo on the CPU and for ranks
that share one card.
"""
from __future__ import annotations

from repro_torch.api.config import FitConfig
from repro_torch.api.engines.base import EngineRun
from repro_torch.api.engines.mesh import _MeshRun
from repro_torch.core import collectives
from repro_torch.core.distributed_xl import make_xl_nested_round
from repro_torch.obs import span


class _XLRun(_MeshRun):
    """A `_MeshRun` whose cluster stats are sharded over ``model_axis``.

    Data placement (the model ranks of a data shard hold the same rows),
    b's units (rows a data shard), the n_valid tail mask and the
    canonical checkpoint layout are the mesh run's. Checkpoints are
    written with WHOLE (k, d) stats, so an XL checkpoint restores onto the
    local and mesh engines and onto any model dim that divides k, and
    the other way round. Only the stats' seams and the round differ.
    """
    _engine_name = "xl"

    def __init__(self, X, config: FitConfig, mesh, X_val, init_C, device):
        if config.model_axis not in mesh.mesh_dim_names:
            raise ValueError(
                f"backend='xl' needs mesh axis {config.model_axis!r} "
                f"(config.model_axis) to shard the centroids over, but "
                f"the mesh only has axes {tuple(mesh.mesh_dim_names)}")
        m = collectives.axis_size(mesh, config.model_axis)
        if config.k % m:
            raise ValueError(
                f"backend='xl' shards the k={config.k} centroids over "
                f"mesh axis {config.model_axis!r} of size {m}; k must "
                f"divide evenly")
        self._m = m
        super().__init__(X, config, mesh, X_val, init_C, device)

    def _k_rows(self) -> slice:
        k_local = self._config.k // self._m
        lo = collectives.axis_index(self._mesh,
                                    self._config.model_axis) * k_local
        return slice(lo, lo + k_local)

    def _whole_k(self, t, dim: int = 0):
        # one all-gather over the model dim: the ranks' slices in
        # coordinate order, which is the order of the global k
        parts = collectives.all_gather(t, self._mesh,
                                       self._config.model_axis)
        return parts.movedim(0, dim).flatten(dim, dim + 1)

    def nested_step(self, state, b, capacity):
        self._ensure_prefix(b)   # out of core: no-op on in-memory fits
        round_fn = make_xl_nested_round(
            self._mesh, self._data_axes, model_axis=self._config.model_axis,
            b_local=b, rho=self._config.rho, bounds=self._config.bounds,
            capacity=capacity, use_shalf=self._config.use_shalf,
            n_real=self._n_real, plan=self.kernel_plan)
        return round_fn(self._Xd, state)


class XLEngine:
    """Centroid-sharded engine: points over the data dims, k over the
    model dim.

    The regime past `MeshEngine`: when k d no longer replicates, each
    model rank scans only its k-slice with the top-2 kernel, the
    per-point top-2 triples are tree-folded over the model dim, and the
    S/v deltas are reduce-scattered, so no rank holds full-k statistics
    between rounds. It drives the same `run_loop` (growth, overflow
    retry, patience, checkpoints) as every other engine; every rank
    builds it and calls `begin` with the same dataset and config.
    """

    def __init__(self, mesh):
        self.mesh = mesh

    def begin(self, X, config: FitConfig, *, X_val=None, init_C=None,
              device="cuda") -> EngineRun:
        with span("engine.place"):
            return _XLRun(X, config, self.mesh, X_val, init_C, device)

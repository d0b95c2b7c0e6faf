"""`FitConfig`: the single, validated, serialisable fit specification.

The port's own copy of `repro/api/config.py`: the same fields, validation
and `to_dict` shape, so manifests of the two packages compare. The one
difference is ``kernel_backend``, which takes None, "ref" or "cuda". A
config is frozen (hashable), validates itself at construction, and
round-trips through plain dicts.

Fields whose feature is not ported yet (the backends other than
"local") are kept and validated here; the fit refuses them with
`NotImplementedError` (see `api/loop.py`).

Non-finite floats (`rho=inf`, `time_budget_s=inf`) are encoded as the
string ``"inf"`` in `to_dict()` so manifests stay strict-JSON.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Dict, Optional, Tuple

ALGORITHMS = ("lloyd", "lloyd-elkan", "mb", "sgd", "mbf", "gb", "tb")
BOUNDS = ("none", "hamerly2", "elkan", "exponion")

# elkan's per-(point, centroid) lower-bound matrix is O(n*k) f32 — fine
# for the paper-scale reference path, a silent OOM at serving-scale k.
# Warn once the matrix would cross this many bytes (64 MB per shard).
ELKAN_STATE_WARN_BYTES = 64 * 1024 * 1024


def bound_state_bytes(bounds: str, n: int, k: int) -> int:
    """Per-shard bytes of per-point bound state for ``n`` local rows.

    hamerly2/exponion keep two f32 scalars per point (`PointState.d` /
    `.lb`); elkan adds the (n, k) f32 lower-bound matrix. Recorded in
    benchmark manifests so memory-vs-work tradeoffs are auditable.
    """
    if bounds == "elkan":
        return 4 * n * (k + 2)
    if bounds in ("hamerly2", "exponion"):
        return 4 * n * 2
    return 0


BACKENDS = ("local", "mesh", "xl", "multihost")

# algorithms driven by the nested grow-batch loop (the tb/gb family)
NESTED_ALGOS = ("gb", "tb", "lloyd-elkan")

# backends whose rounds run under shard_map (points row-sharded)
SHARDED_BACKENDS = ("mesh", "xl", "multihost")


def _enc_float(x: float) -> Any:
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    return float(x)


def _dec_float(x: Any) -> float:
    return float(x)


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """In-loop checkpointing policy for `api.loop.run_loop`.

    Attributes:
      checkpoint_dir  directory for the `CheckpointStore` (created on
                      first save).
      save_every      save the full loop state every N host rounds (a
                      final save always happens at loop exit).
      keep            keep-N garbage collection of old steps.
      background      snapshot to host RAM synchronously, write to disk
                      on a worker thread (the loop keeps dispatching).
    """
    checkpoint_dir: str
    save_every: int = 10
    keep: int = 3
    background: bool = False

    def __post_init__(self):
        if not self.checkpoint_dir:
            raise ValueError("checkpoint_dir must be a non-empty path")
        if self.save_every < 1:
            raise ValueError(f"save_every must be >= 1, got "
                             f"{self.save_every}")
        if self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CheckpointConfig":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"unknown CheckpointConfig fields: {sorted(unknown)}")
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Everything a fit needs besides the data and the execution engine.

    Attributes mirror the paper's knobs:
      k           number of clusters.
      algorithm   lloyd | lloyd-elkan | mb | sgd | mbf | gb | tb.
      rho         batch-growth threshold (Alg. 6); inf = gb-inf/tb-inf.
      b0          initial (global) batch size for the nested family /
                  fixed batch size for mb / mbf.
      bounds      none | hamerly2 | elkan | exponion (nested family
                  only). All bound families are EXACT — labels are
                  bit-equal to bounds="none" on every backend; they
                  differ only in how much provably-unnecessary work
                  they skip and how much state they carry:
                    none      no state, every point scans all k.
                    hamerly2  2 f32/point; failing points scan all k
                              (capacity-compacted). The default.
                    elkan     (n, k) f32 lower-bound matrix — tightest
                              per-pair pruning, but O(n*k) memory: at
                              k=1024, b=64k that is 256 MB f32 PER
                              SHARD (construction warns at k >= 512;
                              prefer exponion at large k).
                    exponion  2 f32/point (hamerly2's layout); failing
                              points scan only an annular candidate
                              set from the sorted inter-centroid
                              table — the large-k family.
      capacity_floor  smallest power-of-two recompute bucket the
                  capacity policy will compile (see `api/loop.py::cap_bucket`).
      max_rounds / time_budget_s   work budgets.
      eval_every  validation-MSE cadence (rounds), when X_val is given.
      use_shalf   include Hamerly's s(j)/2 test in the hamerly2 bound.
      kernel_backend  None (auto: the CUDA kernels on a CUDA device, the
                  plain versions on the CPU) | "ref" | "cuda" — resolved
                  once per fit into a `repro_torch.kernels.plan.KernelPlan`
                  at `engine.begin`.
      shuffle     pre-shuffle the data (paper init = first k of shuffle).
      converge_patience  quiet full-batch rounds before declaring
                  convergence.
      seed        numpy PRNG seed for shuffle + mb resampling.
      backend     "local" (single process) | "mesh" (shard_map engine,
                  centroids replicated) | "xl" (shard_map engine with
                  the centroids additionally sharded over model_axis —
                  for k too large to replicate) | "multihost" (the mesh
                  engine across jax.distributed processes; every
                  process runs the same loop over its own rows).
      data_axes   mesh axes the points are row-sharded over
                  (mesh/xl/multihost).
      model_axis  mesh axis the centroids are sharded over (xl only);
                  k must divide by the axis size.
      data_source path of an on-disk `repro.data.store` chunk store to
                  stream the training rows from (out-of-core fits).
                  `NestedKMeans.fit()` may then be called with no X; a
                  store path or `ChunkStore` passed directly to fit()
                  takes precedence. Nested family only — mb/lloyd
                  resample or scan the full dataset each round, which
                  defeats the bounded-memory prefix streaming.
      checkpoint  optional `CheckpointConfig`: save the full loop state
                  every N rounds so the fit can be killed and resumed
                  (see `NestedKMeans.fit(resume=True)`). On multihost
                  only process 0 writes; any process count can restore.
      coordinator_address / num_processes / process_id
                  jax.distributed initialisation for backend=
                  "multihost" (set all three, with a per-process
                  process_id, or none — None means the caller already
                  initialised jax.distributed, or runs one process).
      trace_dir   directory for `repro_torch.obs` structured traces:
                  the estimator attaches a `FitObserver` writing
                  rotating JSONL span/event logs plus a metrics export,
                  in the JAX package's format. None (default) disables
                  tracing — the loop's obs seam is a no-op. Read back
                  with ``python -m repro_torch.obs summarize DIR``.
    """
    k: int
    algorithm: str = "tb"
    rho: float = math.inf
    b0: int = 5000
    bounds: str = "hamerly2"
    capacity_floor: int = 1024
    max_rounds: int = 10_000
    time_budget_s: float = math.inf
    eval_every: int = 10
    use_shalf: bool = True
    kernel_backend: Optional[str] = None
    shuffle: bool = True
    converge_patience: int = 2
    seed: int = 0
    backend: str = "local"
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    data_source: Optional[str] = None
    checkpoint: Optional[CheckpointConfig] = None
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    trace_dir: Optional[str] = None

    def __post_init__(self):
        if isinstance(self.checkpoint, dict):
            object.__setattr__(self, "checkpoint",
                               CheckpointConfig.from_dict(self.checkpoint))
        if not isinstance(self.k, int) or self.k < 1:
            raise ValueError(f"k must be a positive int, got {self.k!r}")
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; "
                             f"expected one of {ALGORITHMS}")
        if self.bounds not in BOUNDS:
            raise ValueError(f"unknown bounds {self.bounds!r}; "
                             f"expected one of {BOUNDS}")
        if self.bounds == "elkan" and self.k >= 512:
            # n is unknown until fit time, so gate on k alone: at this k
            # any batch >= 32k rows crosses ELKAN_STATE_WARN_BYTES.
            warnings.warn(
                f"bounds='elkan' allocates an O(n*k) f32 lower-bound "
                f"matrix — at k={self.k} that is "
                f"{4 * self.k / 1024:.0f} KB per point per shard "
                f"(k=1024, b=64k: 256 MB). For large k prefer "
                f"bounds='exponion': hamerly2-sized state with annular "
                f"candidate pruning.", ResourceWarning, stacklevel=2)
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"expected one of {BACKENDS}")
        if self.b0 < 1:
            raise ValueError(f"b0 must be >= 1, got {self.b0}")
        if self.rho <= 0:
            raise ValueError(f"rho must be > 0, got {self.rho}")
        if self.max_rounds < 1:
            raise ValueError(f"max_rounds must be >= 1, got "
                             f"{self.max_rounds}")
        if self.eval_every < 1:
            raise ValueError(f"eval_every must be >= 1, got "
                             f"{self.eval_every}")
        if self.converge_patience < 1:
            raise ValueError("converge_patience must be >= 1")
        if self.capacity_floor < 1:
            raise ValueError("capacity_floor must be >= 1")
        if self.kernel_backend not in (None, "ref", "cuda"):
            raise ValueError(f"unknown kernel_backend "
                             f"{self.kernel_backend!r}")
        if self.backend in SHARDED_BACKENDS \
                and self.algorithm not in NESTED_ALGOS:
            raise ValueError(
                f"the {self.backend} engine only runs the nested family "
                f"(gb/tb/lloyd-elkan); got algorithm={self.algorithm!r}")
        if self.data_source is not None:
            if not isinstance(self.data_source, str) or not self.data_source:
                raise ValueError(
                    f"data_source must be a non-empty store path, got "
                    f"{self.data_source!r}")
            if self.algorithm not in NESTED_ALGOS:
                raise ValueError(
                    f"data_source streams the nested prefix from disk; "
                    f"algorithm={self.algorithm!r} rescans or resamples "
                    f"the full dataset each round (pass X in memory "
                    f"instead)")
        coord = (self.coordinator_address, self.num_processes,
                 self.process_id)
        if any(c is not None for c in coord) \
                and any(c is None for c in coord):
            raise ValueError(
                "set coordinator_address, num_processes and process_id "
                "together (or none of them)")
        if self.coordinator_address is not None \
                and self.backend != "multihost":
            raise ValueError(
                f"coordinator fields only apply to backend='multihost', "
                f"got backend={self.backend!r}")
        if self.num_processes is not None and self.num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got "
                             f"{self.num_processes}")
        if self.process_id is not None and not (
                0 <= self.process_id < (self.num_processes or 1)):
            raise ValueError(
                f"process_id must be in [0, num_processes), got "
                f"{self.process_id} of {self.num_processes}")
        if self.trace_dir is not None and (
                not isinstance(self.trace_dir, str) or not self.trace_dir):
            raise ValueError(
                f"trace_dir must be a non-empty directory path or None, "
                f"got {self.trace_dir!r}")
        if not isinstance(self.data_axes, tuple):
            object.__setattr__(self, "data_axes", tuple(self.data_axes))
        if not self.model_axis or not isinstance(self.model_axis, str):
            raise ValueError(
                f"model_axis must be a non-empty mesh axis name, got "
                f"{self.model_axis!r}")
        if self.backend == "xl" and self.model_axis in self.data_axes:
            raise ValueError(
                f"model_axis {self.model_axis!r} cannot also be a data "
                f"axis {self.data_axes!r}")

    # -- canonicalisation ---------------------------------------------------

    def resolve(self, n: int) -> "FitConfig":
        """Fold the paper's algorithm aliases into their canonical forms.

        sgd == mb with b=1; lloyd-elkan == tb at b0=N with elkan bounds;
        gb == tb with bounds="none"; the non-bounded algorithms carry
        bounds="none". ``n`` is the dataset size (lloyd-elkan needs it).
        """
        c = self
        if c.algorithm == "sgd":
            c = dataclasses.replace(c, algorithm="mb", b0=1)
        if c.algorithm == "lloyd-elkan":
            c = dataclasses.replace(c, algorithm="tb", b0=n,
                                    bounds="elkan", rho=math.inf)
        if c.algorithm == "gb":
            c = dataclasses.replace(c, algorithm="tb", bounds="none")
        if c.algorithm in ("lloyd", "mb", "mbf"):
            c = dataclasses.replace(c, bounds="none")
        return c

    # -- serialisation ------------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """JSON-safe dict (inf encoded as the string "inf")."""
        d = dataclasses.asdict(self)
        d["rho"] = _enc_float(self.rho)
        d["time_budget_s"] = _enc_float(self.time_budget_s)
        d["data_axes"] = list(self.data_axes)
        if self.checkpoint is not None:
            d["checkpoint"] = self.checkpoint.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FitConfig":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown FitConfig fields: {sorted(unknown)}")
        if "rho" in d:
            d["rho"] = _dec_float(d["rho"])
        if "time_budget_s" in d:
            d["time_budget_s"] = _dec_float(d["time_budget_s"])
        if "data_axes" in d:
            d["data_axes"] = tuple(d["data_axes"])
        return cls(**d)

"""Retrace auditor: round keys first seen == the pow2 bucket count.

Port of `repro/analysis/retrace.py`. The schedule walks a power-of-two
lattice — b doubling from b0, capacity in {None} | pow2 — so a fit needs
a handful of distinct round shapes, and a compiled executable or a CUDA
graph per (b, capacity) bucket (ROADMAP Queue 2 item 4) stays a handful.
The historical bug class: a float hyperparameter (rho) or an exact-need
capacity sneaking into the key, so that every round is a new key.

`repro_torch.util.tracecount` hooks `core.rounds.nested_round`; the
port has no jit, so a "trace" is the first call of a (site, statics) key
in the process. The auditor empties the counters (the port has no real
compile cache, so this costs nothing), runs a full growth schedule,
records which (b, capacity) buckets the loop invoked (overflow retries
included), logs their count, and asserts:

  retrace             one (b, capacity) bucket seen under more than one
                      key — something off-lattice (rho, flags) varies
                      per round
  unexpected-trace    a key for a bucket the schedule never invoked
  off-lattice-bucket  an invoked bucket off the pow2 lattice (b not in
                      the b0-doubling chain, capacity not a power of
                      two below b)
  missing-trace       an invoked bucket that keyed nothing: the hook no
                      longer sees the round, or its key drops the bucket

From empty counters the fit must key each invoked bucket exactly once,
so a clean audit means first-seen keys == distinct buckets.
`trace_violations` alone (the JAX package's contract, also used on a
warm cache) does not treat a missing trace as a violation.

On the sharded backends every rank audits its own process (one rank per
process; JAX audits one controller over forced host devices): call
`audit_backend` on every rank of an initialised group. b is a data
rank's prefix on mesh, multihost and xl alike, as in JAX's engines, so
the invoked buckets are the same on every rank and equal JAX's on as
many devices; the lattice is checked against the rank's own b0 and
b_max. The xl round keys the site ``xl_nested_round``, the others
``nested_round``.
"""
from __future__ import annotations

import inspect
import logging
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.report import Violation, rel

_log = logging.getLogger(__name__)

Bucket = Tuple[int, Optional[int]]


def _parse_bucket(statics: Tuple[Tuple[str, str], ...]) -> Bucket:
    d = dict(statics)
    b = int(d["b"])
    cap = d.get("capacity", "None")
    return b, (None if cap == "None" else int(cap))


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def lattice_violations(invoked: Sequence[Bucket], b0: int, b_max: int,
                       *, site_file: str, site_line: int, qualname: str
                       ) -> List[Violation]:
    chain = set()
    b = max(1, b0)
    while True:
        chain.add(min(b, b_max))
        if b >= b_max:
            break
        b *= 2
    out = []
    for bb, cap in sorted(set(invoked),
                          key=lambda t: (t[0], t[1] or 0)):
        bad_b = bb not in chain
        bad_cap = cap is not None and (not _is_pow2(cap) or cap >= bb)
        if bad_b or bad_cap:
            what = []
            if bad_b:
                what.append(f"b={bb} not on the b0={b0} doubling chain")
            if bad_cap:
                what.append(f"capacity={cap} not a pow2 below b")
            out.append(Violation(
                checker="retrace", kind="off-lattice-bucket",
                file=site_file, line=site_line, qualname=qualname,
                detail="; ".join(what)))
    return out


def trace_violations(diff: Dict, invoked: Sequence[Bucket], site: str, *,
                     site_file: str, site_line: int, qualname: str
                     ) -> List[Violation]:
    """Compare the keys first seen (a `tracecount.diff`) against the
    invoked buckets. Several keys for one bucket == something besides
    (b, capacity) varies per round — the rho-retrace class."""
    per_bucket: Dict[Bucket, int] = {}
    keys_of: Dict[Bucket, List] = {}
    for (s, statics), n in diff.items():
        if s != site:
            continue
        bucket = _parse_bucket(statics)
        per_bucket[bucket] = per_bucket.get(bucket, 0) + n
        keys_of.setdefault(bucket, []).append(dict(statics))
    invoked_set = set(invoked)
    out: List[Violation] = []
    for bucket, n in sorted(per_bucket.items(),
                            key=lambda t: (t[0][0], t[0][1] or 0)):
        b, cap = bucket
        if n > 1:
            varying = {k for d in keys_of[bucket] for k in d
                       if len({str(x.get(k)) for x in keys_of[bucket]})
                       > 1}
            out.append(Violation(
                checker="retrace", kind="retrace",
                file=site_file, line=site_line, qualname=qualname,
                detail=(f"bucket (b={b}, capacity={cap}) traced {n}x "
                        f"in one fit"
                        + (f" — keyed by {sorted(varying)}"
                           if varying else ""))))
        if bucket not in invoked_set:
            out.append(Violation(
                checker="retrace", kind="unexpected-trace",
                file=site_file, line=site_line, qualname=qualname,
                detail=(f"traced bucket (b={b}, capacity={cap}) that "
                        f"the schedule never invoked")))
    return out


def _round_site(backend: str):
    """(tracecount site name, file, line, qualname) of the round body
    that keys this backend's rounds."""
    if backend == "xl":
        from repro_torch.core import distributed_xl as m
        fn, site = m.xl_nested_round, "xl_nested_round"
    else:
        from repro_torch.core import rounds as m
        fn, site = m.nested_round, "nested_round"
    return (site, rel(inspect.getsourcefile(fn)),
            fn.__code__.co_firstlineno, site)


def _mesh_for(backend: str, config):
    """JAX's audit layout over every rank of the process group: a flat
    data dim for mesh; (world/2, 2) for xl when the world is even, else
    (world, 1); None for multihost (the engine builds its own flat mesh)
    and local."""
    if backend not in ("mesh", "xl"):
        return None
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    if not dist.is_initialized():
        raise RuntimeError(
            f"backend={backend!r} audits this rank's part of a sharded "
            f"fit: call torch.distributed.init_process_group first, on "
            f"every rank")
    world = dist.get_world_size()
    if backend == "xl":
        m = 2 if world % 2 == 0 and world > 1 else 1
        return make_host_mesh((world // m, m),
                              (config.data_axes[0], config.model_axis))
    return make_host_mesh((world,), config.data_axes)


def audit_backend(backend: str = "local", *, X=None, config=None,
                  device="cuda", stats: Optional[Dict] = None
                  ) -> List[Violation]:
    """Empty the trace counters, run one full growth schedule on
    ``backend`` and check the key contract; logs the count of distinct
    (b, capacity) buckets the fit invoked. ``X``/``config`` (an
    unresolved `FitConfig`, whose backend becomes ``backend``) audit a
    given fit; by default JAX's: 4096 x 8 normal rows from seed 0, k = 8,
    b0 = max(2k, n // 64), 40 rounds. ``device``: the card unless the
    caller asks for the CPU. mesh, xl and multihost audit this rank's
    part of the fit on every rank of an initialised group, over
    `_mesh_for`'s mesh. ``stats``, if given, is filled with the fit's
    ``calls`` (round calls), ``buckets`` (distinct (b, capacity)
    buckets), ``keys`` (first-seen keys) and ``invoked`` (the buckets,
    sorted)."""
    import dataclasses

    import numpy as np

    from repro_torch.api.config import FitConfig
    from repro_torch.api.engines import make_engine
    from repro_torch.api.loop import run_loop
    from repro_torch.util import tracecount

    if X is None:
        X = np.random.default_rng(0).normal(size=(4096, 8)).astype(
            np.float32)
    if config is None:
        k = 8
        config = FitConfig(k=k, b0=max(2 * k, X.shape[0] // 64), seed=0,
                           max_rounds=40, capacity_floor=32)
    config = dataclasses.replace(config, backend=backend).resolve(X.shape[0])
    run = make_engine(config, mesh=_mesh_for(backend, config)).begin(X, config, device=device)

    invoked: List[Bucket] = []
    inner_step = run.nested_step

    def logged_step(state, b, capacity):
        invoked.append((b, capacity))
        return inner_step(state, b, capacity)

    run.nested_step = logged_step
    b0_local, b_max = run.b, run.b_max
    tracecount.reset()              # a fresh cache: every key counts
    before = tracecount.snapshot()
    run_loop(run, config)
    diff = tracecount.diff(before)
    del run.nested_step             # break the cycle run -> step -> run

    site, site_file, site_line, qual = _round_site(backend)
    qual = f"{qual}[backend={backend}]"
    out = trace_violations(diff, invoked, site, site_file=site_file,
                           site_line=site_line, qualname=qual)
    out.extend(lattice_violations(invoked, b0_local, b_max,
                                  site_file=site_file,
                                  site_line=site_line, qualname=qual))
    keyed = {_parse_bucket(statics) for (s, statics) in diff if s == site}
    buckets = sorted(set(invoked), key=lambda t: (t[0], t[1] or 0))
    for b, cap in buckets:
        if (b, cap) not in keyed:
            out.append(Violation(
                checker="retrace", kind="missing-trace", file=site_file,
                line=site_line, qualname=qual,
                detail=(f"bucket (b={b}, capacity={cap}) was invoked but "
                        f"keyed nothing from empty counters")))
    n_keys = sum(n for (s, _), n in diff.items() if s == site)
    _log.info("retrace[%s]: %d round calls over %d distinct (b, capacity) "
              "buckets, %d first-seen keys: %s", backend, len(invoked),
              len(buckets), n_keys, buckets)
    if stats is not None:
        stats.update(calls=len(invoked), buckets=len(buckets), keys=n_keys,
                     invoked=buckets)
    return out


def selftest() -> List[Violation]:
    """Replant the rho-keyed retrace and an exact-need (non-pow2)
    capacity schedule; the checker must flag both."""
    from repro_torch.analysis import _selftest as fx
    return fx.retrace_fixture_violations(trace_violations,
                                         lattice_violations)

"""The host control loop: growth schedule, capacity bucketing, overflow
retry and convergence patience.

Port of `repro/api/loop.py::run_loop` for one process. Every per-round
decision branches only on `HostRoundInfo`, the round's scalars landed on
the host by `fetch_round_info` in ONE transfer per round (one per
overflow attempt), or on the resolved config. Every algorithm and bound
family runs, with in-loop checkpoints and resume in the JAX package's
on-disk format, on the local, mesh, xl and multihost backends. On the
sharded backends every rank runs this loop over the same schedule: the
scalars are reduced inside the round, and the wall-clock flag and the
resume decision come from the coordinator.

Two seams make the loop observable and checkable, as in the JAX
package (both defined in `api.engines.base`, whose `EngineRun` reports
through them too): `LoopAudit` brackets each round and each sanctioned
device<->host crossing (`repro_torch.analysis.hostsync` audits a live
fit through it), and `ObsSink` receives each round's host-landed scalars
(`repro_torch.obs.FitObserver` writes them to the trace directory of
``FitConfig(trace_dir=...)``). `repro_torch.analysis` also lints this
module for branches that do not derive from `HostRoundInfo`, the
resolved config or the sanctioned `run` primitives (``python -m
repro_torch.analysis lint``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api.config import FitConfig
from repro_torch.api.engines.base import (_NULL_AUDIT, _NULL_OBS,
                                          EngineRun, LoopAudit, ObsSink)
from repro_torch.api.telemetry import RoundCallback, Telemetry, final_val_mse
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core.state import KMeansState, RoundInfo
from repro_torch.kernels.plan import next_pow2


# --------------------------------------------------------------------------
# the ONE steady-state device->host crossing
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HostRoundInfo:
    """`RoundInfo` landed on the host: plain Python scalars."""
    batch_mse: float
    n_changed: int
    n_recomputed: int
    n_active: int
    overflow: bool
    grow: bool
    r_median: float
    p_max: float


_FIELDS = [f.name for f in dataclasses.fields(RoundInfo)]


def fetch_round_info(info: RoundInfo) -> HostRoundInfo:
    """Land the round's scalars on the host in ONE transfer.

    The scalars are stacked as float64 (exact for the f32 floats and the
    int32 counts) and copied with one ``.cpu()``, which also waits for
    the round to finish.
    """
    host = torch.stack([getattr(info, f).to(torch.float64)
                        for f in _FIELDS]).cpu().tolist()
    v = dict(zip(_FIELDS, host))
    return HostRoundInfo(
        batch_mse=v["batch_mse"], n_changed=int(v["n_changed"]),
        n_recomputed=int(v["n_recomputed"]), n_active=int(v["n_active"]),
        overflow=bool(v["overflow"]), grow=bool(v["grow"]),
        r_median=v["r_median"], p_max=v["p_max"])


# --------------------------------------------------------------------------
# result record
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FitOutcome:
    """What a fit produces: centroids + full state + telemetry.

    ``labels`` is in the CALLER's row order; ``-1`` marks rows the nested
    batch never reached.
    """
    C: np.ndarray
    state: KMeansState
    labels: np.ndarray
    telemetry: List[Telemetry]
    converged: bool
    algorithm: str
    config: FitConfig
    kernel_plan: Optional[Dict[str, Any]] = None

    @property
    def final_mse(self) -> float:
        return final_val_mse(self.telemetry)


# --------------------------------------------------------------------------
# capacity policy
# --------------------------------------------------------------------------

def cap_bucket(need: int, b: int, floor: int) -> Optional[int]:
    """Power-of-two capacity with 2x slack; None == recompute everything."""
    cap = max(floor, next_pow2(2 * max(need, 1)))
    return None if cap >= b else cap


# --------------------------------------------------------------------------
# the host loop
# --------------------------------------------------------------------------

def run_loop(run: EngineRun, config: FitConfig, *,
             on_round: Optional[RoundCallback] = None,
             resume_from: Optional[Union[str, Path, CheckpointStore]] = None,
             resolved_resume: Optional[Tuple[int, Dict[str, Any]]] = None,
             trace: Optional[List[Dict[str, Any]]] = None,
             audit: Optional[LoopAudit] = None,
             obs: Optional[ObsSink] = None
             ) -> FitOutcome:
    """Growth schedule + capacity bucketing + overflow retry + patience.

    ``config`` must already be `resolve()`d (no alias algorithms):
    lloyd, mb or mbf take one step a round; tb (gb and lloyd-elkan
    resolve to it) takes nested rounds under the growth schedule.

    When ``config.checkpoint`` is set, the FULL loop state (engine
    state, batch size, capacity bucket, patience counter, work clock and
    telemetry) is saved atomically every ``save_every`` rounds, plus
    once at loop exit, beside the ``config.to_dict()`` manifest.
    ``resume_from`` (a directory or `CheckpointStore`) restores the
    latest such checkpoint, so a killed fit continues bit-identically.
    ``resolved_resume``: the ``(step, extra)`` pair a caller already
    read with ``run.resolve_resume`` from the same store.

    ``trace``: optional list; one dict per completed tb round —
    ``{"round", "b_global", "capacity", "quiet_rounds"}`` — is appended
    AFTER the round's schedule updates: the loop's control-flow
    fingerprint, the same as the JAX package's for the same fit.

    ``audit``: optional `LoopAudit` whose scopes bracket each round body
    and its sanctioned crossings (the host-sync auditor's hook). ``None``
    uses the no-op scopes.

    ``obs``: optional `ObsSink` receiving each round's host-landed
    scalars, span timings (eval, checkpoint, store ingest) and overflow
    retries, usually a `repro_torch.obs.FitObserver`. ``None`` uses the
    no-op sink. The loop does not close the sink; its creator does.
    """
    audit = audit if audit is not None else _NULL_AUDIT
    obs = obs if obs is not None else _NULL_OBS
    algorithm = config.algorithm
    bounds = config.bounds
    state = run.state
    b = run.b
    capacity: Optional[int] = None
    telemetry: List[Telemetry] = []
    t_work = 0.0
    quiet_rounds = 0
    converged = False
    start_round = 0
    run.bind_obs(obs)
    run.bind_audit(audit)

    ckpt = config.checkpoint
    store = (CheckpointStore(ckpt.checkpoint_dir, keep=ckpt.keep)
             if ckpt is not None else None)

    if store is not None and resume_from is None:
        # a FRESH checkpointed fit supersedes whatever run lives in the
        # directory: left in place, the old (higher-numbered) steps
        # would garbage-collect this run's early saves on arrival and a
        # later resume would silently restore the stale fit
        if run.is_coordinator and store.latest_step() is not None:
            store.clear()
        run.barrier()

    if resume_from is not None:
        rstore = (resume_from if isinstance(resume_from, CheckpointStore)
                  else CheckpointStore(resume_from,
                                       keep=ckpt.keep if ckpt else 3))
        step, extra = (resolved_resume if resolved_resume is not None
                       else run.resolve_resume(rstore))
        if step is None:
            raise FileNotFoundError(
                f"resume_from={resume_from!r} holds no checkpoints")
        if not extra or "loop" not in extra:
            raise ValueError(
                f"checkpoint step {step} has no loop metadata; it was "
                f"not written by run_loop")
        emeta, loop = extra["engine"], extra["loop"]
        # dataset identity gate: a resume against a DIFFERENT dataset
        # would restore per-point state that describes rows the new data
        # does not have. Checkpoints with no "data" key skip the check.
        saved_fp = extra.get("data")
        fp = run.data_fingerprint
        if saved_fp is not None and fp is not None and saved_fp != fp:
            diff = sorted(k for k in set(saved_fp) | set(fp)
                          if saved_fp.get(k) != fp.get(k))
            raise ValueError(
                f"checkpoint step {step} was written for a different "
                f"dataset (fingerprint differs on {diff}: checkpoint "
                f"{saved_fp} vs this fit {fp}); resuming would silently "
                f"mislabel the new data — refusing")
        state = run.restore(rstore, step, emeta)
        telemetry = [Telemetry.from_dict(r) for r in extra["telemetry"]]
        t_work = float(loop["t_work"])
        quiet_rounds = int(loop["quiet_rounds"])
        converged = bool(loop.get("converged", False))
        start_round = int(loop["rounds_done"])
        # b is stored in GLOBAL rows; ceil-divide onto this engine's
        # shard count so every previously-seen point stays inside the
        # prefix when the shard count changed across the restore
        b = max(1, min(-(-int(loop["b_global"]) // run.n_shards),
                       run.b_max))
        cap = loop.get("capacity")
        capacity = (int(cap) if cap is not None
                    and int(emeta.get("n_shards", 0)) == run.n_shards
                    else None)
        run.barrier()

    def record(hinfo: HostRoundInfo, dt_s: float) -> None:
        val_mse = None
        if len(telemetry) % config.eval_every == 0:
            # validation eval is a sanctioned device->host read (outside
            # the paper's timed region, like every eval)
            with audit.sanctioned_scope("eval_mse"), obs.span("eval_mse"):
                val_mse = run.eval_mse(state)
        rec = Telemetry.from_round(hinfo, round=len(telemetry), t=t_work,
                                   val_mse=val_mse)
        telemetry.append(rec)
        # the sink sees only host values; b and capacity are the ones
        # THIS round used (before the schedule's updates)
        obs.round_end(rec.round, hinfo, dt_s=dt_s, t_work=t_work,
                      b_global=min(b * run.n_shards, run.n_points),
                      capacity=capacity, quiet_rounds=quiet_rounds,
                      algorithm=algorithm, val_mse=val_mse,
                      store=run.store_metrics())
        if on_round:
            on_round(rec)

    def save_checkpoint() -> None:
        tree, emeta = run.capture(state)
        extra = {
            "config": config.to_dict(),
            "data": run.data_fingerprint,
            "engine": emeta,
            "loop": {"rounds_done": len(telemetry),
                     "b_global": b * run.n_shards, "capacity": capacity,
                     "quiet_rounds": quiet_rounds, "t_work": t_work,
                     "converged": converged},
            "telemetry": [r.to_dict() for r in telemetry],
        }
        if run.is_coordinator:
            store.save(len(telemetry), tree, extra=extra,
                       background=ckpt.background)
        run.barrier()

    for _ in range(start_round, config.max_rounds):
        if converged:        # resumed an already-finished fit
            break
        with audit.round_scope():
            if math.isfinite(config.time_budget_s):
                # the wall clock is the one host-local input to the
                # schedule: the coordinator decides, every process obeys
                with audit.sanctioned_scope("sync_flag"):
                    out_of_time = run.sync_flag(
                        t_work >= config.time_budget_s)
                if out_of_time:
                    break
            t0 = time.perf_counter()
            if algorithm == "lloyd":
                new_state, info = run.lloyd_step(state)
                with audit.sanctioned_scope("round_info"):
                    hinfo = fetch_round_info(info)
            elif algorithm in ("mb", "mbf"):
                new_state, info = run.mb_step(state,
                                              fixed=algorithm == "mbf")
                with audit.sanctioned_scope("round_info"):
                    hinfo = fetch_round_info(info)
            else:  # the tb family (gb is tb with bounds="none")
                while True:
                    new_state, info = run.nested_step(state, b, capacity)
                    with audit.sanctioned_scope("round_info"):
                        hinfo = fetch_round_info(info)
                    if not hinfo.overflow:
                        break
                    # overflow retry: same input state, doubled bucket —
                    # exactness is never traded for speed
                    obs.count("overflow_retry")
                    capacity = (None
                                if capacity is None or 2 * capacity >= b
                                else 2 * capacity)
            dt_s = time.perf_counter() - t0
            t_work += dt_s
            state = new_state
            record(hinfo, dt_s)

            if algorithm == "tb":
                if bounds == "hamerly2":
                    need = -(-hinfo.n_recomputed // run.n_shards)
                    if hinfo.grow and b < run.b_max:
                        # a doubling adds b new points that always need
                        # a full pass: start the grown bucket dense
                        capacity = None
                    else:
                        capacity = cap_bucket(need, b,
                                              config.capacity_floor)
                if hinfo.grow:
                    b = min(2 * b, run.b_max)
                if (hinfo.n_active >= run.n_active_target
                        and hinfo.n_changed == 0 and hinfo.p_max == 0.0):
                    quiet_rounds += 1
                else:
                    quiet_rounds = 0
                if trace is not None:
                    trace.append({"round": len(telemetry) - 1,
                                  "b_global": b * run.n_shards,
                                  "capacity": capacity,
                                  "quiet_rounds": quiet_rounds})
                if quiet_rounds >= config.converge_patience:
                    converged = True
                    break
            elif algorithm == "lloyd" and hinfo.n_changed == 0:
                converged = True
                break
            # mb and mbf stop only at max_rounds or the time budget

            if store is not None and len(telemetry) % ckpt.save_every == 0:
                with audit.sanctioned_scope("checkpoint"), \
                        obs.span("checkpoint"):
                    save_checkpoint()

    if store is not None:
        # one final save so a resumed-after-finish fit is a no-op loop
        with obs.span("checkpoint"):
            save_checkpoint()
            if run.is_coordinator:
                store.wait()
        run.barrier()

    # final validation point, unless the last round already evaluated
    if not (telemetry and telemetry[-1].val_mse is not None):
        final = run.eval_mse(state)
        if final is not None:
            telemetry.append(Telemetry(
                round=len(telemetry), t=t_work,
                b=min(b * run.n_shards, run.n_points), batch_mse=None,
                n_changed=0, n_recomputed=0, grow=False, r_median=None,
                val_mse=final))

    obs.fit_end(rounds=len(telemetry), t_work=t_work, converged=converged)

    # un-shuffle the final assignments back to the caller's row order
    a = run.host_points(state)
    labels = np.full(run.n_points, -1, np.int32)
    valid = run.orig_index >= 0
    labels[run.orig_index[valid]] = a[valid]

    # the outcome's state holds the whole stats (the XL engine's rounds
    # hold a k-slice a rank) and this rank's points
    stats = run.fetch_stats(state)
    state = dataclasses.replace(state, stats=stats)
    plan = run.kernel_plan
    return FitOutcome(C=stats.C.cpu().numpy(), state=state, labels=labels,
                      telemetry=telemetry, converged=converged,
                      algorithm=config.algorithm, config=config,
                      kernel_plan=plan.to_dict() if plan else None)

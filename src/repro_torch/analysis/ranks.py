"""The runtime auditors on the sharded backends, one rank per process.

The port's mesh, xl and multihost engines run one rank per process, so
where JAX audits one controller over forced host devices
(`repro/analysis/__main__.py`'s ``--devices``), the port audits in every
rank: `audit_rank` runs hostsync and retrace on each sharded backend
inside an initialised process group and returns what each found, and
`spawn_audits` starts ``ranks`` such processes (`spawn_and_join`:
`torch.multiprocessing` spawn under a deadline), gathers their results
and stops every one of them.

The group: gloo on the CPU; on the card NCCL with one rank per card, or
gloo when there are more ranks than cards (the ranks then share one
card, whose tensors gloo stages through the host: the collectives that
hostsync sanctions by name, `repro_torch.core.collectives`).
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence

#: the auditors that run per rank
RANK_CHECKS = ("hostsync", "retrace")


def audit_rank(checks: Sequence[str], backends: Sequence[str], *,
               device="cuda", trace_dir: Optional[str] = None,
               selftest: bool = False) -> Dict:
    """Run ``checks`` (of `RANK_CHECKS`) on each of ``backends`` in this
    rank's process, inside an initialised group; every rank calls it
    with the same arguments. Returns ``{check: {backend: (violations,
    stats)}}``; with ``selftest``, ``{check: {"selftest": (findings,
    {})}}`` from each check's planted bug class instead."""
    from repro_torch.analysis import hostsync, retrace
    from repro_torch.launch.mesh import rank_device
    device = rank_device(device)
    out: Dict = {}
    for check in checks:
        if check not in RANK_CHECKS:
            raise ValueError(f"{check!r} is not audited per rank")
        res = out.setdefault(check, {})
        if selftest:
            res["selftest"] = ((hostsync.selftest(device=device)
                                if check == "hostsync"
                                else retrace.selftest()), {})
            continue
        for b in backends:
            stats: Dict = {}
            if check == "hostsync":
                td = f"{trace_dir.rstrip('/')}/{b}" if trace_dir else None
                found = hostsync.audit_backend(b, device=device,
                                               trace_dir=td, stats=stats)
            else:
                found = retrace.audit_backend(b, device=device, stats=stats)
            res[b] = (found, stats)
    return out


def _rank_main(rank: int, world: int, root: str, backend: str, checks,
               backends, device: str, trace_dir, selftest: bool) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(root, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=300))
    try:
        res = audit_rank(checks, backends, device=device,
                         trace_dir=trace_dir, selftest=selftest)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_and_join(fn, args: tuple, nprocs: int, timeout_s: float,
                   what: str) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes and wait
    for them. Raises `TimeoutError` when they are not done in
    ``timeout_s`` (a process still running then is killed, not waited
    for), and a rank's error when one fails."""
    import torch.multiprocessing as tmp
    ctx = tmp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{what}: the {nprocs} ranks did not "
                                   f"finish in {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def spawn_audits(checks: Sequence[str], backends: Sequence[str], *,
                 ranks: int, device="cuda", trace_dir: Optional[str] = None,
                 selftest: bool = False, timeout_s: float = 600.0
                 ) -> List[Dict]:
    """`audit_rank` in ``ranks`` spawned processes of one new group;
    their results by rank. Raises `TimeoutError` when the ranks are not
    done in ``timeout_s`` (a stuck rank is killed, not waited for), and
    the rank's error when one fails."""
    import torch
    # NCCL on the card with a card a rank, else gloo
    backend = ("nccl" if torch.device(device).type == "cuda"
               and ranks <= torch.cuda.device_count() else "gloo")
    root = tempfile.mkdtemp(prefix="repro_torch_audit_")
    try:
        spawn_and_join(_rank_main,
                       (ranks, root, backend, tuple(checks), tuple(backends),
                        str(device), trace_dir, selftest),
                       ranks, timeout_s, "the audits")
        out = []
        for r in range(ranks):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)

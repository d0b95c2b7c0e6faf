"""``python -m repro_torch.analysis`` — run the port's invariant checkers.

Usage::

    python -m repro_torch.analysis lint                 # AST lint (no torch)
    python -m repro_torch.analysis hostsync retrace     # runtime auditors
    python -m repro_torch.analysis all                  # everything
    python -m repro_torch.analysis all --selftest       # planted-bug check
    python -m repro_torch.analysis all --selftest --device cpu
    python -m repro_torch.analysis hostsync --trace-dir DIR
    python -m repro_torch.analysis all --backends local,mesh,xl --ranks 4

Exit status 0 iff every requested check is clean (or, with
``--selftest``, iff every checker still flags its planted bug class).
The runtime auditors run on ``--device``, the card by default: without
one they refuse to run unless the caller asks for ``--device cpu``,
where hostsync's sync-debug layer has nothing to watch and its
interceptor layer alone runs.

``--backends`` (default local,mesh,xl, as in JAX) names the engines that
hostsync and retrace audit. The local one runs in this process. The
sharded ones (mesh, xl, multihost) run one rank per process in the
port, so where JAX forces ``--devices N`` host devices, this CLI spawns
``--ranks N`` processes of one group (gloo on the CPU; on the card NCCL
with a card a rank, else gloo on the one card), audits each backend in
every rank (`repro_torch.analysis.ranks`) and gathers the violations
here; with ``--selftest`` each rank replants the bug classes. The
in-place check (donation) audits the local engine.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import List

CHECKS = ("lint", "hostsync", "retrace", "donation")
RUNTIME_CHECKS = {"hostsync", "retrace", "donation"}
SHARDED_BACKENDS = ("mesh", "xl", "multihost")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="invariant checkers: replicated-control-flow lint, "
                    "host-sync / retrace / in-place auditors")
    p.add_argument("checks", nargs="*", default=["all"],
                   choices=list(CHECKS) + ["all"],
                   help="which checkers to run (default: all)")
    p.add_argument("--backends", default="local,mesh,xl",
                   help="comma-separated backends for the runtime "
                        "auditors (default: local,mesh,xl)")
    p.add_argument("--ranks", type=int, default=4,
                   help="processes, one rank each, that audit the "
                        "sharded backends (default: 4)")
    p.add_argument("--device", default="cuda",
                   help="device of the runtime auditors (default: cuda; "
                        "cpu audits without the sync-debug layer)")
    p.add_argument("--trace-dir", default=None,
                   help="attach a repro_torch.obs FitObserver to the "
                        "hostsync audits (per-backend subdirectories): "
                        "shows that tracing adds no synchronisation")
    p.add_argument("--selftest", action="store_true",
                   help="instead of auditing the tree, replant each "
                        "checker's bug class and FAIL if it is no longer "
                        "flagged")
    args = p.parse_args(argv)

    checks = list(CHECKS) if "all" in args.checks else \
        [c for c in CHECKS if c in args.checks]
    backends = [b.strip() for b in args.backends.split(",") if b.strip()]
    unknown = [b for b in backends
               if b != "local" and b not in SHARDED_BACKENDS]
    if unknown:
        p.error(f"unknown backends {unknown}; choose from local, "
                f"{', '.join(SHARDED_BACKENDS)}")
    logging.basicConfig(level=logging.INFO, format="    %(message)s",
                        stream=sys.stdout)
    if set(checks) & RUNTIME_CHECKS:
        import torch
        if (torch.device(args.device).type == "cuda"
                and not torch.cuda.is_available()):
            print(f"{p.prog}: no CUDA device for the runtime auditors "
                  f"(torch.cuda.is_available() is False); pass --device "
                  f"cpu to audit on the CPU", file=sys.stderr)
            return 2
        print(f"runtime auditors on device={args.device}")

    sharded = [b for b in backends if b in SHARDED_BACKENDS]
    per_rank = [c for c in checks if c in ("hostsync", "retrace")]
    ranks = []
    if sharded and per_rank:
        from repro_torch.analysis.ranks import spawn_audits
        ranks = spawn_audits(per_rank, sharded, ranks=args.ranks,
                             device=args.device, trace_dir=args.trace_dir,
                             selftest=args.selftest)
        _log_ranks(ranks)

    failures = 0
    for check in checks:
        violations = _run_check(check, args, backends)
        for r, res in enumerate(ranks):
            for what, (found, _) in res.get(check, {}).items():
                if args.selftest and not found:
                    raise AssertionError(
                        f"{check} selftest in rank {r}: the planted bug "
                        f"class was not flagged")
                violations = violations + list(found)
        if args.selftest:
            # a selftest SUCCEEDS by producing violations (the planted
            # bug was caught); _run_check raises when teeth are lost
            print(f"[{check}] selftest: planted bug class flagged "
                  f"({len(violations)} finding(s))")
            for v in violations:
                print(f"    {v}")
            continue
        if violations:
            failures += len(violations)
            print(f"[{check}] FAIL — {len(violations)} violation(s):")
            for v in sorted(violations,
                            key=lambda v: (v.file, v.line, v.kind)):
                print(f"    {v}")
        else:
            scope = ""
            if check in ("hostsync", "retrace"):
                scope = (f" (backends: {', '.join(backends)}; ranks "
                         f"{args.ranks if sharded else 1}; device "
                         f"{args.device})")
            elif check in RUNTIME_CHECKS:
                scope = f" (backends: local; device {args.device})"
            print(f"[{check}] OK{scope}")
    if failures:
        print(f"\n{failures} violation(s); see "
              f"src/repro_torch/analysis/allowlist.txt for how sanctioned "
              f"exceptions are recorded")
        return 1
    return 0


def _run_check(check: str, args, backends: List[str]):
    if check == "lint":
        from repro_torch.analysis import replicated_lint
        if args.selftest:
            from repro_torch.analysis.report import repo_root
            fixture = (repo_root()
                       / "src/repro_torch/analysis/_selftest.py")
            found = replicated_lint.lint_file(fixture, mode="engine")
            missing = ({"branch", "host-coercion", "rng-draw"}
                       - {v.kind for v in found})
            if missing:
                raise AssertionError(
                    f"lint selftest: planted kinds not flagged: "
                    f"{sorted(missing)}")
            return found
        return replicated_lint.run()
    if check == "hostsync":
        from repro_torch.analysis import hostsync
        if args.selftest:
            return hostsync.selftest(device=args.device)
        if "local" not in backends:
            return []
        td = f"{args.trace_dir.rstrip('/')}/local" if args.trace_dir else None
        return hostsync.audit_backend(backend="local", trace_dir=td,
                                      device=args.device)
    if check == "retrace":
        from repro_torch.analysis import retrace
        if args.selftest:
            return retrace.selftest()
        if "local" not in backends:
            return []
        return retrace.audit_backend(backend="local", device=args.device)
    if check == "donation":
        from repro_torch.analysis import donation
        if args.selftest:
            return donation.selftest(device=args.device)
        return donation.run(device=args.device)
    raise ValueError(f"unknown check {check!r}")


def _log_ranks(ranks) -> None:
    """One line per (check, backend) with what each rank measured."""
    for check in ("hostsync", "retrace"):
        for what in (ranks[0].get(check) or {}):
            stats = [res[check][what][1] for res in ranks]
            if what == "selftest":
                print(f"    {check} selftest by rank: findings "
                      f"{[len(res[check][what][0]) for res in ranks]}")
            elif check == "retrace":
                print(f"    retrace[{what}] by rank: round calls "
                      f"{[s['calls'] for s in stats]}, first-seen keys "
                      f"{[s['keys'] for s in stats]} over "
                      f"{[s['buckets'] for s in stats]} buckets: "
                      f"{stats[0]['invoked']}")
            else:
                print(f"    hostsync[{what}] by rank: rounds "
                      f"{[s['rounds'] for s in stats]}, gloo collectives "
                      f"of CUDA tensors {[s['staged'] for s in stats]}, "
                      f"their syncs (sanctioned) "
                      f"{[s['staged_syncs'] for s in stats]}")


if __name__ == "__main__":
    sys.exit(main())

"""``python -m repro_torch.analysis`` — run the port's invariant checkers.

Usage::

    python -m repro_torch.analysis lint                 # AST lint (no torch)
    python -m repro_torch.analysis hostsync retrace     # runtime auditors
    python -m repro_torch.analysis all                  # everything
    python -m repro_torch.analysis all --selftest       # planted-bug check
    python -m repro_torch.analysis all --selftest --device cpu
    python -m repro_torch.analysis hostsync --trace-dir DIR

Exit status 0 iff every requested check is clean (or, with
``--selftest``, iff every checker still flags its planted bug class).
The runtime auditors run on ``--device``, the card by default: without
one they refuse to run unless the caller asks for ``--device cpu``,
where hostsync's sync-debug layer has nothing to watch and its
interceptor layer alone runs. Only the "local" backend is audited: the
sharded backends wait for ROADMAP Queue 1 item 9 step 5 and are refused
by name.
"""
from __future__ import annotations

import argparse
import logging
import sys
from typing import List

CHECKS = ("lint", "hostsync", "retrace", "donation")
RUNTIME_CHECKS = {"hostsync", "retrace", "donation"}
PORTED_BACKENDS = ("local",)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="invariant checkers: replicated-control-flow lint, "
                    "host-sync / retrace / in-place auditors")
    p.add_argument("checks", nargs="*", default=["all"],
                   choices=list(CHECKS) + ["all"],
                   help="which checkers to run (default: all)")
    p.add_argument("--backends", default="local",
                   help="comma-separated backends for the runtime "
                        "auditors (default and only ported: local)")
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
    unported = [b for b in backends if b not in PORTED_BACKENDS]
    if unported:
        p.error(f"backends {unported} are not audited on repro_torch yet "
                f"(ROADMAP Queue 1 item 9 step 5); only "
                f"{list(PORTED_BACKENDS)}")
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

    failures = 0
    for check in checks:
        violations = _run_check(check, args, backends)
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
            scope = (f" (backends: {', '.join(backends)}; device "
                     f"{args.device})" if check in RUNTIME_CHECKS else "")
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
        out = []
        for b in backends:
            td = (f"{args.trace_dir.rstrip('/')}/{b}"
                  if args.trace_dir else None)
            out.extend(hostsync.audit_backend(backend=b, trace_dir=td,
                                              device=args.device))
        return out
    if check == "retrace":
        from repro_torch.analysis import retrace
        if args.selftest:
            return retrace.selftest()
        out = []
        for b in backends:
            out.extend(retrace.audit_backend(backend=b, device=args.device))
        return out
    if check == "donation":
        from repro_torch.analysis import donation
        if args.selftest:
            return donation.selftest(device=args.device)
        return donation.run(device=args.device)
    raise ValueError(f"unknown check {check!r}")


if __name__ == "__main__":
    sys.exit(main())

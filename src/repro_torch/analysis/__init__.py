"""`repro_torch.analysis` — invariant checkers for the port's control
plane (the port of `repro.analysis`).

  lint       static AST pass over `repro_torch.api.loop` and the
             engines: flags per-round branches, host coercions and RNG
             draws that do not derive from `HostRoundInfo`, the resolved
             `FitConfig` or the sanctioned `run` primitives
             (`replicated_lint`).
  hostsync   runs a fit under `torch.cuda.set_sync_debug_mode` (on a
             card) and an interceptor on `torch.Tensor`'s conversion
             surface (everywhere), scoped by
             `repro_torch.api.loop.LoopAudit`: any synchronisation
             outside the sanctioned scopes is a violation with the
             caller's file:line (`hostsync`).
  retrace    runs a full growth schedule and counts the round keys first
             seen (`repro_torch.util.tracecount`): every (b, capacity)
             bucket must be keyed at most once and sit on the pow2
             lattice (`retrace`).
  donation   the port has no donated buffers; its check is of in-place
             reuse: a store-backed fit fills one device buffer, never a
             copy of it (`donation`).

Run them all: ``python -m repro_torch.analysis all`` (see `__main__`).
Each checker also has a ``selftest`` that replants its bug class and
asserts the checker still catches it at the planted file:line.
Sanctioned exceptions live in `allowlist.txt` next to this file; every
entry carries a reason and stale entries fail the lint.

Importing the package or the lint touches no torch; the runtime
auditors import it when they run.
"""
from __future__ import annotations

from repro_torch.analysis.report import Violation

__all__ = ["Violation"]

"""Planted bug classes — the checkers' negative fixtures.

Port of `repro/analysis/_selftest.py`. Each fixture replants a bug class
the JAX package actually shipped (and fixed), in the shape a regression
in the port would take, so the selftests prove the checkers still have
teeth:

  * `LeakyRun` — a per-round schedule decision read off a live device
    scalar (branch + host coercion), an ambient RNG draw and an
    ``.item()``. The lint must flag its AST; the host-sync auditor must
    flag the synchronisation at runtime at this file's line (on a card,
    sync-debug mode must catch it too).
  * `CopyingRun` — a segment write that copies the whole data buffer
    (the JAX package's donated-but-copying segment writer, in torch's
    spelling: a ``clone`` of ``_Xd``). The in-place check must flag it,
    statically at the planted line and at runtime.
  * `retrace_fixture_violations` — the rho-keyed retrace: the same
    (b, capacity) bucket keyed once per round because a float
    hyperparameter rides in the key; plus an exact-need (non-pow2)
    capacity schedule.

Imported by the checkers' ``selftest()`` entry points and by
tests/test_torch_analysis.py; not part of the production import graph.
"""
from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np
import torch

from repro_torch.analysis.report import Violation, rel
from repro_torch.api.engines.local import _LocalRun

_HERE = rel(__file__)


# -- device-scalar control flow ----------------------------------------------

class LeakyRun(_LocalRun):
    """A local run whose schedule leaks device state into host control
    flow — every pattern below is a planted lint/hostsync violation."""

    def nested_step(self, state, b, capacity):
        # branch + float() coercion on a live device scalar: one hidden
        # synchronisation per round, and divergent control flow on a
        # multi-process run
        if float(torch.max(state.stats.p)) > 1e9:
            b = max(1, b // 2)
        return super().nested_step(state, b, capacity)

    def mb_step(self, state, fixed):
        # ambient entropy: processes draw different numbers
        if np.random.random() < 2.0:
            pass
        return super().mb_step(state, fixed)

    def eval_mse(self, state):
        # .item() on device state without derivation from HostRoundInfo
        _ = state.stats.sse[0].item()
        return super().eval_mse(state)


class LeakyEngine:
    def begin(self, X, config, *, X_val=None, init_C=None, device="cuda"):
        return LeakyRun(X, config, X_val, init_C, device)


def leaky_line(marker: str) -> int:
    """1-based line of the first planted occurrence of ``marker``."""
    for i, line in enumerate(
            Path(__file__).read_text().splitlines(), start=1):
        if marker in line and "marker" not in line:
            return i
    raise AssertionError(f"marker {marker!r} not found in fixture")


def hostsync_fixture_violations(audit_backend, device) -> List[Violation]:
    found = audit_backend(backend="local", device=device,
                          engine_factory=lambda cfg: LeakyEngine())
    line = leaky_line("if float(torch.max(state.stats.p)) > 1e9:")
    planted = [v for v in found if v.file == _HERE and v.line == line]
    if not planted:
        raise AssertionError(
            "hostsync selftest: the planted device-scalar branch was NOT "
            f"flagged at {_HERE}:{line}; got only: "
            f"{[str(v) for v in found]}")
    if torch.device(device).type == "cuda" and not any(
            v.kind == "cuda-sync" for v in planted):
        raise AssertionError(
            "hostsync selftest: sync-debug mode did not catch the planted "
            f"device-scalar branch at {_HERE}:{line}")
    return planted


# -- copying segment write ----------------------------------------------------

class CopyingRun(_LocalRun):
    """A store-backed run whose segment write copies the whole buffer:
    the fill holds two generations of the data on the device."""

    def _ensure_prefix(self, b):
        if self._store is None or b <= self._filled:
            return
        rows = self._store.take(self._perm[self._filled:b]).astype(
            np.float32, copy=False)
        Xd = self._Xd.clone()
        Xd[self._filled:b].copy_(torch.from_numpy(rows))
        self._Xd = Xd
        self._filled = b


class CopyingEngine:
    def begin(self, X, config, *, X_val=None, init_C=None, device="cuda"):
        return CopyingRun(X, config, X_val, init_C, device)


def donation_fixture_violations(scan_file, check_inplace,
                                device) -> List[Violation]:
    line = leaky_line("Xd = self._Xd.clone()")
    found = scan_file(Path(__file__))
    if not [v for v in found if v.line == line]:
        raise AssertionError(
            "donation selftest: the planted copying segment write was NOT "
            f"flagged by the scan at {_HERE}:{line}")
    live = check_inplace(device=device,
                         engine_factory=lambda cfg: CopyingEngine())
    if not [v for v in live if v.file == _HERE]:
        raise AssertionError(
            "donation selftest: the planted copying segment write was NOT "
            f"flagged at runtime; got only: {[str(v) for v in live]}")
    return found + live


# -- retrace class: per-round cache keys -------------------------------------

def retrace_fixture_violations(trace_violations, lattice_violations
                               ) -> List[Violation]:
    from repro_torch.core.rounds import nested_round
    from repro_torch.core.state import init_state
    from repro_torch.util import tracecount

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    state = init_state(X, 4)

    # rho drifting per round keys the round: the same (b, capacity)
    # bucket, a fresh key every round. The counters start empty, as a
    # fresh compile cache would, so the plant counts in any process.
    tracecount.reset()
    invoked = []
    before = tracecount.snapshot()
    for rho in (1.90, 1.91, 1.92):
        nested_round(X, state, b=32, rho=rho, bounds="hamerly2",
                     capacity=16, use_shalf=True, plan=None)
        invoked.append((32, 16))
    diff = tracecount.diff(before)
    found = trace_violations(
        diff, invoked, "nested_round", site_file=_HERE,
        site_line=leaky_line("for rho in (1.90, 1.91, 1.92)"),
        qualname="retrace_fixture[rho-keyed]")

    # exact-need capacity: off the pow2 lattice, one key per distinct
    # need value — unbounded growth of the key set
    found += lattice_violations(
        [(32, 24), (48, None)], 32, 64, site_file=_HERE,
        site_line=leaky_line("[(32, 24), (48, None)]"),
        qualname="retrace_fixture[off-lattice]")
    if not [v for v in found if v.kind == "retrace"]:
        raise AssertionError(
            "retrace selftest: the planted rho-keyed retrace was NOT "
            "flagged")
    if not [v for v in found if v.kind == "off-lattice-bucket"]:
        raise AssertionError(
            "retrace selftest: the planted off-lattice schedule was "
            "NOT flagged")
    return found

"""Host-sync auditor: run a real fit and prove the steady-state loop
waits for the device ZERO times outside the sanctioned crossings.

Port of `repro/analysis/hostsync.py`. `repro_torch.api.loop.run_loop`
brackets every round with `LoopAudit.round_scope()` and each sanctioned
crossing with `sanctioned_scope(what)` (round_info / eval_mse /
sync_flag / checkpoint, and the engine's mid-fit "upload"s).
`HostSyncAudit` subclasses that seam: inside a round and outside a
sanctioned scope, every synchronisation is recorded as a violation with
the CALLER's file:line (the deepest frame of this repository, past
torch's own frames). Violations are recorded, never raised, so one
audited fit reports every site at once.

Two detection layers, because one is blind on the CPU:

  * (a) on a CUDA device, ``torch.cuda.set_sync_debug_mode("warn")`` is
    on inside the round scope and off inside the sanctioned scopes:
    every call that makes the host wait for the stream (a device->host
    copy, ``.item()``, a pageable host->device copy, an explicit
    synchronise) raises torch's "called a synchronizing CUDA operation"
    warning, which the audit catches (forced to "always") and turns into
    a violation. The mode is process-global: the audit sets it only
    around a fit's rounds and restores the previous mode in ``finally``;
    audit fits only, not a service whose reader threads share it. Torch
    calls the mode a prototype that does not see every synchronising
    operation: this layer sees what torch's own checks see.
  * (b) on every device, an interceptor on `torch.Tensor`'s conversion
    surface (``item``, ``tolist``, ``__float__``, ``__int__``,
    ``__bool__``, ``__index__``, ``__array__``, ``numpy``, and ``cpu``
    of a non-CPU tensor): this is how a host coercion lands in Python
    (``float(x)``, ``if x:``, ``np.asarray(x)``) and what makes a CPU
    audit see anything.

The audited fit runs AFTER an identical unaudited warm-up fit, so every
kernel is built and loaded and the allocator has grown: the audit sees
the steady state. The historical bug class: a schedule decision read off
a live device scalar each round — correct results, but every round
stalled the launch queue. `selftest()` replants it and asserts the
auditor still catches it.
"""
from __future__ import annotations

import contextlib
import traceback
import warnings
from pathlib import Path
from typing import List, Optional

import torch

from repro_torch.analysis.report import Violation, rel, repo_root
from repro_torch.api.loop import LoopAudit, run_loop

#: conversion surface intercepted on `torch.Tensor` (layer (b)); ``cpu``
#: counts only for a tensor that is not on the CPU already
_HOOKS = ("__float__", "__int__", "__bool__", "__index__", "item",
          "tolist", "__array__", "numpy", "cpu")

#: the warning `torch.cuda.set_sync_debug_mode("warn")` raises
_SYNC_WARNING = "called a synchronizing CUDA operation"


class HostSyncAudit(LoopAudit):
    """Records unsanctioned synchronisations instead of raising.

    ``device``: the fit's device; layer (a) runs when it is a CUDA
    device. Layer (b) runs while `installed()` is entered.
    """

    def __init__(self, label: str = "fit", device=None):
        self.label = label
        self.violations: List[Violation] = []
        self._in_round = 0
        self._sanctioned = 0
        self.cuda = (device is not None
                     and torch.device(device).type == "cuda")

    # -- LoopAudit seam ------------------------------------------------------

    @contextlib.contextmanager
    def round_scope(self):
        self._in_round += 1
        try:
            if self.cuda:
                with self._sync_debug():
                    yield
            else:
                yield
        finally:
            self._in_round -= 1

    @contextlib.contextmanager
    def sanctioned_scope(self, what: str):
        self._sanctioned += 1
        prev = torch.cuda.get_sync_debug_mode() if self.cuda else 0
        if self.cuda:
            torch.cuda.set_sync_debug_mode(0)
        try:
            yield
        finally:
            if self.cuda:
                torch.cuda.set_sync_debug_mode(prev)
            self._sanctioned -= 1

    # -- layer (a): sync-debug mode on the card ------------------------------

    @contextlib.contextmanager
    def _sync_debug(self):
        prev = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.filterwarnings("always", message=_SYNC_WARNING)
            shown = warnings.showwarning

            def show(message, category, filename, lineno, file=None,
                     line=None):
                if _SYNC_WARNING in str(message):
                    self.notify("cuda-sync")
                else:
                    shown(message, category, filename, lineno, file, line)

            # catch_warnings restores showwarning on exit
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(prev)

    # -- interceptor plumbing ------------------------------------------------

    @property
    def active(self) -> bool:
        return self._in_round > 0 and self._sanctioned == 0

    def notify(self, kind: str) -> None:
        if not self.active:
            return
        file, line, qual, snippet = _caller_site()
        v = Violation(checker="hostsync",
                      kind=kind if kind == "cuda-sync" else f"d2h-{kind}",
                      file=file, line=line, qualname=qual,
                      detail=(f"unsanctioned synchronisation in the "
                              f"steady-state loop ({self.label}): "
                              f"{snippet}"))
        if v not in self.violations:
            self.violations.append(v)

    @contextlib.contextmanager
    def installed(self):
        """Layer (b): patch `torch.Tensor`'s conversion surface while
        this audit is entered (restored when the last audit leaves)."""
        _active.append(self)
        _ensure_patched()
        try:
            yield self
        finally:
            _active.remove(self)
            if not _active:
                _unpatch()


_active: List[HostSyncAudit] = []
#: name -> torch.Tensor's own attribute, or None where it was inherited
_saved = {}


def _caller_site():
    """Deepest stack frame inside this repo (and outside this module):
    the code that made the synchronisation. torch's frames, the warnings
    machinery and this module are walked past."""
    here = str(Path(__file__).resolve())
    root = str(repo_root())
    for f in reversed(traceback.extract_stack()):
        fn = str(Path(f.filename).resolve()) if f.filename else ""
        if fn == here:
            continue
        if fn.startswith(root + "/"):
            return (rel(fn), f.lineno, f.name,
                    (f.line or "").strip() or "<unknown>")
    return ("<outside-repo>", 0, "?", "?")


def _notify_all(kind: str) -> None:
    for audit in _active:
        audit.notify(kind)


def _ensure_patched() -> None:
    if _saved:
        return
    cls = torch.Tensor
    for name in _HOOKS:
        orig = getattr(cls, name)
        kind = name.strip("_")
        if name == "cpu":
            def wrapper(self, *a, __orig=orig, **kw):
                if self.device.type != "cpu":
                    _notify_all("cpu")
                return __orig(self, *a, **kw)
        else:
            def wrapper(self, *a, __orig=orig, __kind=kind, **kw):
                _notify_all(__kind)
                return __orig(self, *a, **kw)
        _saved[name] = cls.__dict__.get(name)
        setattr(cls, name, wrapper)


def _unpatch() -> None:
    cls = torch.Tensor
    for name, orig in _saved.items():
        if orig is None:
            delattr(cls, name)
        else:
            setattr(cls, name, orig)
    _saved.clear()


# -- the audited fit ---------------------------------------------------------

def audit_backend(backend: str = "local", *, X=None, X_val=None,
                  config=None, device="cuda", engine_factory=None,
                  trace_dir: Optional[str] = None) -> List[Violation]:
    """Warm up, then run one audited fit on ``backend``; returns the
    unsanctioned synchronisations.

    ``X``/``X_val``/``config`` (an unresolved `FitConfig`) audit a given
    fit; by default a small one (2048 x 8 normal rows, k = 8, b0 = 64,
    24 rounds, eval every 4) is made from a seed. ``device``: the card
    unless the caller asks for the CPU. ``engine_factory`` overrides
    engine construction (the selftest injects a leaky engine).
    ``trace_dir`` attaches a `repro_torch.obs.FitObserver` to the
    AUDITED fit, showing that tracing adds no synchronisation of its
    own. Only the "local" backend is audited; the sharded backends wait
    for ROADMAP Queue 1 item 9 step 5.
    """
    import numpy as np

    from repro_torch.api.config import FitConfig
    from repro_torch.api.engines import make_engine

    if backend != "local":
        raise NotImplementedError(
            f"hostsync: backend={backend!r} is not ported to repro_torch "
            f"yet (ROADMAP Queue 1 item 9 step 5)")
    if X is None:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(2048, 8)).astype(np.float32)
        X_val = rng.normal(size=(256, 8)).astype(np.float32)
    n, d = X.shape
    if config is None:
        config = FitConfig(k=8, b0=64, max_rounds=24, eval_every=4,
                           capacity_floor=32)
    config = config.resolve(n)

    def fit(audit: Optional[HostSyncAudit], obs=None):
        engine = (engine_factory(config) if engine_factory is not None
                  else make_engine(config))
        run = engine.begin(X, config, X_val=X_val, device=device)
        return run_loop(run, config, audit=audit, obs=obs)

    fit(None)                       # build and load every kernel
    obs = None
    if trace_dir is not None:
        from repro_torch.obs import FitObserver
        obs = FitObserver(trace_dir, process_id=0, k=config.k, d=d,
                          bounds=config.bounds,
                          meta={"backend": backend, "audit": "hostsync"})
    audit = HostSyncAudit(label=f"backend={backend}, device={device}",
                          device=device)
    try:
        with audit.installed():
            fit(audit, obs=obs)
    finally:
        if obs is not None:
            obs.close()
    return audit.violations


def selftest(device="cuda") -> List[Violation]:
    """Replant the bug class (a per-round branch on a live device
    scalar) and assert the auditor flags it at the planted file:line
    (on a card: by sync-debug mode too)."""
    from repro_torch.analysis import _selftest as fx
    return fx.hostsync_fixture_violations(audit_backend, device)

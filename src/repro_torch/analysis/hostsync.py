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

A gloo collective of a CUDA tensor (ranks that share one card) copies
through the host and waits for the stream; NCCL's do not, nor do JAX's
in-graph collectives. So the audit does not allowlist collectives: it
registers `HostSyncAudit.staging_scope` with `repro_torch.core
.collectives`, which enters it only around a gloo collective of a CUDA
tensor. The syncs inside it are counted (``staged_syncs``, with the
scopes opened in ``staged``) and are not violations; every other sync in
a round still is, and a one-rank or NCCL fit opens it 0 times. gloo
waits for the stream on its own worker thread, whose sync-debug warning
torch does not route to Python: c10 writes it to the process's stderr
(file descriptor 2). So on a card the scope holds fd 2 in a temporary
file while the collective runs, counts those warnings and writes every
other line back.

The audited fit runs AFTER an identical unaudited warm-up fit, so every
kernel is built and loaded and the allocator has grown: the audit sees
the steady state. On the sharded backends (mesh, xl, multihost) the
port runs one rank per process, so every rank audits its own fit in its
own process (`audit_backend` inside an initialised group; the CLI
spawns the ranks and gathers their violations), where JAX audits one
controller over forced host devices. The historical bug class: a
schedule decision read off a live device scalar each round — correct
results, but every round stalled the launch queue. `selftest()` replants it and asserts the
auditor still catches it.
"""
from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import traceback
import warnings
from pathlib import Path
from typing import Dict, List, Optional

import torch

from repro_torch.analysis.report import Violation, rel, repo_root
from repro_torch.api.loop import LoopAudit, run_loop
from repro_torch.core import collectives

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
        self._staging = 0
        #: rounds audited; gloo collectives of CUDA tensors inside them,
        #: and the syncs layer (a) saw inside those (sanctioned)
        self.rounds = 0
        self.staged = 0
        self.staged_syncs = 0
        self.cuda = (device is not None
                     and torch.device(device).type == "cuda")

    # -- LoopAudit seam ------------------------------------------------------

    @contextlib.contextmanager
    def round_scope(self):
        if not self._in_round:
            self.rounds += 1
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

    @contextlib.contextmanager
    def staging_scope(self):
        """Entered by `repro_torch.core.collectives` around a gloo
        collective of a CUDA tensor, which copies through the host: the
        syncs inside are counted, not recorded as violations (those of
        the calling thread through `notify`, those of gloo's own thread
        from fd 2: see the module's docstring)."""
        counted = self.active
        if counted:
            self.staged += 1
        self._staging += 1
        try:
            if counted and self.cuda:
                with _stderr_syncs() as n:
                    yield
                self.staged_syncs += n[0]
            else:
                yield
        finally:
            self._staging -= 1

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
        if kind == "cuda-sync" and self._staging:
            self.staged_syncs += 1
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
        collectives.STAGING_HOOKS.append(self.staging_scope)
        try:
            yield self
        finally:
            collectives.STAGING_HOOKS.remove(self.staging_scope)
            _active.remove(self)
            if not _active:
                _unpatch()


@contextlib.contextmanager
def _stderr_syncs():
    """Holds file descriptor 2 in a temporary file while entered; on exit
    counts the sync-debug warnings written there into the yielded
    ``[count]`` and writes every other line back to fd 2."""
    sys.stderr.flush()
    saved = os.dup(2)
    n = [0]
    with tempfile.TemporaryFile() as tmp:
        os.dup2(tmp.fileno(), 2)
        try:
            yield n
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
            tmp.seek(0)
            for line in tmp.read().decode(errors="replace").splitlines(
                    keepends=True):
                if _SYNC_WARNING in line:
                    n[0] += 1
                else:
                    os.write(2, line.encode())


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
                  trace_dir: Optional[str] = None,
                  kernel_backend: Optional[str] = None,
                  bounds: str = "hamerly2",
                  stats: Optional[Dict[str, int]] = None
                  ) -> List[Violation]:
    """Warm up, then run one audited fit on ``backend``; returns the
    unsanctioned synchronisations.

    ``X``/``X_val``/``config`` (an unresolved `FitConfig`, whose backend
    becomes ``backend``) audit a given fit; by default JAX's: 2048 x 8
    normal rows from seed 0 (and 256 validation rows), k = 8, b0 =
    max(2k, n // 32), 24 rounds, eval every 4, with ``bounds`` and
    ``kernel_backend``. ``device``: the card unless the caller asks for
    the CPU. ``engine_factory`` overrides engine construction (the
    selftest injects a leaky engine). ``trace_dir`` attaches a
    `repro_torch.obs.FitObserver` to the AUDITED fit, showing that
    tracing adds no synchronisation of its own; on a sharded backend
    each rank writes its own stream (``process_id`` = its rank).

    mesh, xl and multihost audit this rank's part of the fit: call it on
    every rank of an initialised process group, with the same arguments,
    over `retrace._mesh_for`'s mesh (JAX's layouts: a flat data dim; xl
    (world/2, 2) when the world is even, else (world, 1); multihost
    builds its own). ``stats``, if given, is filled with the audited
    fit's ``rounds``, ``staged`` (gloo collectives of CUDA tensors inside
    them) and ``staged_syncs`` (the syncs those made, sanctioned).
    """
    import dataclasses

    import numpy as np

    from repro_torch.analysis.retrace import _mesh_for
    from repro_torch.api.config import FitConfig
    from repro_torch.api.engines import make_engine

    if X is None:
        rng = np.random.default_rng(0)
        X = rng.normal(size=(2048, 8)).astype(np.float32)
        X_val = rng.normal(size=(256, 8)).astype(np.float32)
    n, d = X.shape
    if config is None:
        k = 8
        config = FitConfig(k=k, b0=max(2 * k, n // 32), seed=0,
                           max_rounds=24, eval_every=4, capacity_floor=32,
                           bounds=bounds, kernel_backend=kernel_backend)
    config = dataclasses.replace(config, backend=backend).resolve(n)
    mesh = _mesh_for(backend, config)

    def fit(audit: Optional[HostSyncAudit], obs=None):
        engine = (engine_factory(config) if engine_factory is not None
                  else make_engine(config, mesh=mesh))
        run = engine.begin(X, config, X_val=X_val, device=device)
        return run_loop(run, config, audit=audit, obs=obs)

    fit(None)                       # build and load every kernel
    obs = None
    if trace_dir is not None:
        import torch.distributed as dist

        from repro_torch.obs import FitObserver
        rank = (dist.get_rank() if backend != "local"
                and dist.is_initialized() else 0)
        obs = FitObserver(trace_dir, process_id=rank, k=config.k, d=d,
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
    if stats is not None:
        stats.update(rounds=audit.rounds, staged=audit.staged,
                     staged_syncs=audit.staged_syncs)
    return audit.violations


def selftest(device="cuda") -> List[Violation]:
    """Replant the bug class (a per-round branch on a live device
    scalar) and assert the auditor flags it at the planted file:line
    (on a card: by sync-debug mode too)."""
    from repro_torch.analysis import _selftest as fx
    return fx.hostsync_fixture_violations(audit_backend, device)

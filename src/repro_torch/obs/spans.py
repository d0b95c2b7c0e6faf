"""Spans at the port's layer boundaries: one call, three outputs.

    from repro_torch.obs import span

    with span("engine.upload"):
        Xd = torch.from_numpy(X).to(device)

Every span:

  * **always** adds its `time.perf_counter_ns` duration to the totals of
    its *root*, the thread's outermost open span (``estimator.fit``,
    ``estimator.predict``; a span opened outside any other is a root of
    its own), whose process-unique ``id`` they are kept under. When a
    root closes, its totals join the last `KEEP` roots of its name, under
    one lock taken once a root; `recent_roots` hands them to readers (the
    benchmark's per-layer metrics, an operator's in-process export). No
    torch, no device call, no I/O;
  * **while a sink is bound to the thread** (`observe`: the estimator
    binds the `FitObserver` of ``FitConfig(trace_dir=...)`` before the
    engine places the data, `run_loop` its ``obs``) opens the sink's own
    ``span(name, **attrs)``, which writes the trace directory's record;
  * **while a `torch.profiler` records** opens a profiler range of the
    same name, so the spans lie on the device trace's clock and an idle
    gap of the device can be put down to the span the host was in. The
    range is `torch._C._profiler._RecordFunctionFast`, a plain CPU op:
    ``torch.profiler.record_function`` marks a user annotation, which
    the profiler mirrors onto the device's timeline as if it were
    device work.

The module imports no torch: the profiler is looked for in
`sys.modules`, where it is only if the process imported it, and its
flag is true only while it records (not in its warm-up steps).
"""
from __future__ import annotations

import collections
import itertools
import sys
import threading
import time
from typing import Deque, Dict, List, Tuple

#: roots kept a name
KEEP = 64

_now_ns = time.perf_counter_ns
_modules = sys.modules
_ids = itertools.count(1)
_lock = threading.Lock()
_recent: Dict[str, Deque["Root"]] = {}


class Root:
    """The totals of one root span and every span inside it.

    ``id``: the process-unique id its spans share; ``seconds``: the
    root's own duration; ``ok``: False where it ended in an exception.
    """
    __slots__ = ("id", "name", "thread", "seconds", "ok", "_ns")

    def __init__(self, name: str):
        self.id = next(_ids)
        self.name = name
        self.thread = threading.get_ident()
        self.seconds = 0.0
        self.ok = True
        self._ns: Dict[str, List[int]] = {}

    def total(self, name: str) -> Tuple[float, int]:
        """(seconds, count) of the spans called ``name`` in this root,
        the root itself included; (0.0, 0) where there were none."""
        ns, n = self._ns.get(name, (0, 0))
        return ns * 1e-9, n

    def totals(self) -> Dict[str, Tuple[float, int]]:
        """{name: (seconds, count)} of every span in this root."""
        return {name: self.total(name) for name in self._ns}


class _State:
    """One thread's open root, its open spans and its bound sink's
    ``span``."""
    __slots__ = ("root", "depth", "sink")

    def __init__(self):
        self.root = None
        self.depth = 0
        self.sink = None


_local = threading.local()


def _state() -> _State:
    try:
        return _local.state
    except AttributeError:
        st = _local.state = _State()
        return st


class span:
    """Time a region under ``name`` (see the module's docstring).
    ``attrs`` go to the bound sink's record only."""
    __slots__ = ("name", "attrs", "_t0", "_cm", "_rf")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "span":
        try:
            t = _local.state
        except AttributeError:
            t = _state()
        sink = t.sink
        cm = rf = None
        if sink is not None:
            cm = sink(self.name, **self.attrs)
            cm.__enter__()
        prof = _modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            rf = _modules["torch"]._C._profiler._RecordFunctionFast(
                self.name)
            rf.__enter__()
        self._cm, self._rf = cm, rf
        if t.depth == 0:
            t.root = Root(self.name)
        t.depth += 1
        self._t0 = _now_ns()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        dt = _now_ns() - self._t0
        t = _local.state
        root = t.root
        tot = root._ns.get(self.name)
        if tot is None:
            root._ns[self.name] = [dt, 1]
        else:
            tot[0] += dt
            tot[1] += 1
        t.depth -= 1
        if t.depth == 0:
            t.root = None
            root.seconds = dt * 1e-9
            root.ok = et is None
            with _lock:
                kept = _recent.get(root.name)
                if kept is None:
                    kept = _recent[root.name] = collections.deque(
                        maxlen=KEEP)
                kept.append(root)
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        if self._cm is not None:
            self._cm.__exit__(et, ev, tb)
        return False


class observe:
    """While entered, this thread's spans also open ``sink.span(name,
    **attrs)``. A sink without a ``span`` (None, the loop's no-op
    `ObsSink`) leaves the thread's binding as it is."""
    __slots__ = ("_writer", "_prev", "_state")

    def __init__(self, sink):
        self._writer = getattr(sink, "span", None)

    def __enter__(self) -> "observe":
        t = self._state = _state()
        self._prev = t.sink
        if self._writer is not None:
            t.sink = self._writer
        return self

    def __exit__(self, *exc) -> bool:
        self._state.sink = self._prev
        return False


def recent_roots(name: str) -> List[Root]:
    """The last `KEEP` closed roots called ``name``, of every thread,
    oldest first."""
    with _lock:
        return list(_recent.get(name, ()))

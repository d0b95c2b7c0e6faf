"""Trace counters for the round functions (retrace accounting).

Port of `repro/util/tracecount.py`. The JAX package compiles ONE
executable per power-of-two (b, capacity) bucket and counts a trace each
time a jitted round body runs in Python, which is once per cache miss.
The port has no jit: an eager call runs the body every time. So here a
"trace" is **the first call in the process of a (site, statics) key**,
what one compiled executable, or one CUDA graph, per key would cost. A
key seen again is a cache hit and counts nothing.

The contract keeps its meaning: a set of keys that grows with the round
count, or more than one key for one (b, capacity) bucket, means that
something besides the bucket (a float hyperparameter, an exact-need
capacity) varies per round. `repro_torch.analysis.retrace` drives a
full growth schedule and checks it.

``record`` takes a lock and a set lookup per call, nothing per point,
and never touches a tensor: the hooks stay on unconditionally. A
snapshot or a diff walks every key the process has seen; a caller that
asks every round (the obs sink) takes a `mark` and asks `since` it
instead, which costs only the keys that are new.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict, List, Set, Tuple

_lock = threading.Lock()
_counts: Counter = Counter()
_seen: Set = set()
_order: List = []          # keys in the order first seen
_epoch = 0                 # bumped by every reset

#: key: (site, sorted tuple of (static name, repr(value)))
TraceKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def record(site: str, **statics) -> None:
    """Note a call of ``site`` with these static arguments; the first
    call of a key since the last `reset` counts as its trace.

    Only host values belong here (ints, floats, strings, the frozen
    `KernelPlan`), rendered by ``repr``: their ``repr`` must be the same
    on every round for the key to be fixed.
    """
    key = (site, tuple(sorted((k, repr(v)) for k, v in statics.items())))
    with _lock:
        if key not in _seen:
            _seen.add(key)
            _order.append(key)
            _counts[key] += 1


def snapshot() -> Dict[TraceKey, int]:
    """Current counts (copy): diff two snapshots to scope one run."""
    with _lock:
        return dict(_counts)


def diff(before: Dict[TraceKey, int]) -> Dict[TraceKey, int]:
    """Traces recorded since ``before`` (a `snapshot()` result): the
    keys first seen since then."""
    with _lock:
        return {k: v - before.get(k, 0) for k, v in _counts.items()
                if v - before.get(k, 0) > 0}


def mark() -> Tuple[int, int]:
    """A position in the stream of first sightings, for `since`."""
    with _lock:
        return _epoch, len(_order)


def since(m: Tuple[int, int]) -> Dict[TraceKey, int]:
    """Traces recorded since the `mark` ``m`` (what ``diff`` of a
    snapshot taken then would give), in time proportional to the new
    keys; every key counts as new if the counters were reset since."""
    with _lock:
        start = m[1] if m[0] == _epoch else 0
        return {k: 1 for k in _order[start:]}


def reset() -> None:
    """Forget every key, as if no executable had been compiled."""
    global _epoch
    with _lock:
        _counts.clear()
        _seen.clear()
        _order.clear()
        _epoch += 1

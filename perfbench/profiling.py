"""The traced run's two passes over the program: kernel calls timed with
CUDA events, and a `torch.profiler` trace read for device busy time,
the device operations that took most time, and the idle gaps by what
the host was doing.

`OpTimer` puts a wrapper around each of ``repro_torch.kernels.ops``'s
four kernel entry points for as long as it is entered: an event before
and after each call on the current stream, and the call's shapes, from
which `results` prices its bound (`perfbench.yardstick`) once the pass
is over. What a bound needs of the data (rows of weight 0, rows a bound
settled) is counted then too, so the pass waits on nothing.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import torch

from perfbench import yardstick

OPS = ("assign_top2", "cluster_sum", "fused_nested_round", "fused_round")
#: entries of a breakdown list
TOP = 10


def _shape(op: str, args, kw) -> dict:
    """What `_bound` needs of a call, with tensors whose counts it reads
    later."""
    if op == "assign_top2" or op == "fused_round":
        x, c = args[0], args[1]
        return {"rows": x.shape[0], "k": c.shape[0], "d": x.shape[1]}
    if op == "cluster_sum":
        x, a, k = args[0], args[1], args[2]
        return {"rows": a.shape[0], "k": k, "d": x.shape[1],
                "weights": kw.get("weights")}
    x, c, _, settled, _, _, valid = args[:7]
    return {"rows": x.shape[0], "k": c.shape[0], "d": x.shape[1],
            "settled": settled, "valid": valid}


def _bound_ms(op: str, s: dict) -> float:
    if op == "assign_top2":
        b = yardstick.assign_top2(s["rows"], s["k"], s["d"])
    elif op == "fused_round":
        b = yardstick.fused_round(s["rows"], s["k"], s["d"])
    elif op == "cluster_sum":
        w = s["weights"]
        live = s["rows"] if w is None else int((w != 0).sum())
        b = yardstick.cluster_sum(s["rows"], s["k"], s["d"], w is not None,
                                  live)
    else:
        scanned = int((s["valid"].bool() & ~s["settled"].bool()).sum())
        b = yardstick.fused_nested_round(s["rows"], s["k"], s["d"],
                                         scanned)
    return b * 1e3


class _HostMark:
    """A host-clock stand-in for a CUDA event, where there is no card."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


class OpTimer:
    """Times every call of the program's kernel entry points while
    entered (see the module's docstring). Without a card (``cuda``
    False) the calls are timed on the host clock: for tests only."""

    def __init__(self, cuda: bool = True):
        self.calls: List[tuple] = []
        self.cuda = cuda

    def _mark(self):
        return (torch.cuda.Event(enable_timing=True) if self.cuda
                else _HostMark())

    def _wrap(self, op: str, fn):
        def timed(*args, **kw):
            start, end = self._mark(), self._mark()
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.calls.append((op, start, end, _shape(op, args, kw)))
            return out
        return timed

    def __enter__(self):
        from repro_torch.kernels import ops
        self._ops = ops
        self._orig = {op: getattr(ops, op) for op in OPS}
        for op, fn in self._orig.items():
            setattr(ops, op, self._wrap(op, fn))
        return self

    def __exit__(self, *exc):
        for op, fn in self._orig.items():
            setattr(self._ops, op, fn)
        return False

    def results(self) -> List[dict]:
        """[{"op", "ms", "bound_ms"}] of every call, in call order."""
        if self.cuda:
            torch.cuda.synchronize()
        return [{"op": op, "ms": start.elapsed_time(end),
                 "bound_ms": _bound_ms(op, shape)}
                for op, start, end, shape in self.calls]


# ---------------------------------------------------------------- profiler

def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_label(cpu, gaps) -> Dict[str, float]:
    """Idle seconds by the innermost host operation running at each gap's
    middle ("python" where none was): ``cpu`` are (start, end, name) of
    one thread's properly nested operations, sorted by start."""
    starts = [s for s, _, _ in cpu]
    out: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid)
        name = "python"
        # walking back from the last start before mid, the first
        # operation that still runs at mid is the innermost
        for j in range(i - 1, max(-1, i - 4096), -1):
            if cpu[j][1] >= mid:
                name = cpu[j][2]
                break
        out[name] = out.get(name, 0.0) + (g1 - g0) * 1e-6
    return out


def read_trace(events) -> Optional[dict]:
    """Busy and window seconds, the device operations by time and the idle
    gaps by host operation, from a profiler's events (times in us)."""
    dev, cpu = [], {}
    for e in events:
        tr = e.time_range
        if str(e.device_type).endswith("CUDA"):
            if not e.name.startswith("ProfilerStep"):
                dev.append((tr.start, tr.end, e.name))
        else:
            cpu.setdefault(e.thread, []).append((tr.start, tr.end, e.name))
    if not dev:
        return None
    steps = [(s, e) for evs in cpu.values() for s, e, n in evs
             if n.startswith("ProfilerStep")]
    lo = min([s for s, _ in steps] + [s for s, _, _ in dev])
    hi = max([e for _, e in steps] + [e for _, e, _ in dev])
    busy = _union((max(s, lo), min(e, hi)) for s, e, _ in dev)
    busy_us = sum(e - s for s, e in busy)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((prev, hi))
    by_op: Dict[str, float] = {}
    for s, e, n in dev:
        by_op[n] = by_op.get(n, 0.0) + (e - s) * 1e-6
    # the thread that launched the most device work is the program's
    main = max(cpu, key=lambda t: sum(1 for _, _, n in cpu[t]
                                      if n.startswith("cuda")), default=None)
    idle = (_host_label(sorted(x for x in cpu[main]
                               if not x[2].startswith("ProfilerStep")), gaps)
            if main is not None else {})
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in gaps_top]}


def profiled(loop, cuda: bool, attempts: int = 2) -> Optional[dict]:
    """One warm-up unit, then `loop.profiled_units` units traced; the
    trace read by `read_trace`. A trace that lost the device's work (seen
    on the card at a trace's start) is taken again, once."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for _ in range(attempts):
        got = {}
        prof = profile(activities=acts,
                       schedule=schedule(wait=0, warmup=1, active=1),
                       on_trace_ready=lambda p: got.update(
                           out=read_trace(p.events())))
        with prof:
            loop.unit()
            prof.step()
            for _ in range(loop.profiled_units):
                loop.unit()
            prof.step()
        if got.get("out") is not None:
            return got["out"]
    return None

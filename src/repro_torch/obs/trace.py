"""Structured span tracing: rotating JSONL event logs + a merge reader.

The port's own copy of `repro/obs/trace.py`, line for line below this
docstring: the file names, the envelope and ``OBS_SCHEMA`` are the JAX
package's, so a trace directory written by either package reads the same
in the other (`tests/test_torch_obs.py` holds the two to that).

One `SpanTracer` per process writes one stream of JSON-lines events to
``trace-p<process_id>-<seq>.jsonl`` files under a trace directory,
rotating to a fresh file whenever the current one crosses
``rotate_bytes``. The merge reader (`read_events`) reassembles a
directory into one time-ordered stream.

Event records share a common envelope::

    {"schema": 1, "pid": 0, "id": 17, "ts": 0.0312, ...}

  * ``ph: "meta"``  — one per file: schema version, wall-clock epoch
    (``wall0``) so per-process monotonic offsets can be aligned.
  * ``ph: "span"``  — a timed region, written at span EXIT: ``ts`` is
    the start offset, ``dur_s`` the duration, ``parent`` the id of the
    enclosing span (None at top level). Spans nest per-thread.
  * ``ph: "event"`` — a point event (a round record, a first-seen round
    key) attributed to the current thread's open span, if any.

Timestamps come from the monotonic clock (offsets from tracer
construction), so an NTP step can never make a span negative. Writes
take one lock and one buffered ``write`` per record; nothing here
touches torch or device memory, so the tracer is safe to call from
inside the host loop's audited round scope.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

#: bump when the event envelope changes shape; readers refuse newer
#: schemas rather than mis-parse them.
OBS_SCHEMA = 1

_FILE_PREFIX = "trace-p"


def trace_file_name(process_id: int, seq: int) -> str:
    return f"{_FILE_PREFIX}{process_id:05d}-{seq:04d}.jsonl"


class SpanTracer:
    """Thread-safe JSONL span/event writer for one process."""

    def __init__(self, trace_dir: Union[str, Path], *, process_id: int = 0,
                 rotate_bytes: int = 8 << 20):
        if rotate_bytes < 4096:
            raise ValueError(f"rotate_bytes must be >= 4096, got "
                             f"{rotate_bytes}")
        self.dir = Path(trace_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.process_id = int(process_id)
        self.rotate_bytes = rotate_bytes
        self._t0 = time.monotonic()
        self._wall0 = time.time()
        self._lock = threading.Lock()
        self._local = threading.local()       # per-thread span stack
        self._next_id = 0
        self._seq = 0
        self._file = None
        self._file_bytes = 0
        self._closed = False
        self._open_next_file()

    # -- writer internals ---------------------------------------------------

    def _open_next_file(self) -> None:
        if self._file is not None:
            self._file.close()
        path = self.dir / trace_file_name(self.process_id, self._seq)
        self._seq += 1
        self._file = open(path, "w", encoding="utf-8")
        self._file_bytes = 0
        self._write({"schema": OBS_SCHEMA, "pid": self.process_id,
                     "id": self._take_id(), "ts": self._now(),
                     "ph": "meta", "wall0": self._wall0})

    def _take_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def _write(self, obj: Dict[str, Any]) -> None:
        line = json.dumps(obj, separators=(",", ":"),
                          default=_json_default) + "\n"
        self._file.write(line)
        self._file_bytes += len(line)

    def _emit(self, obj: Dict[str, Any]) -> None:
        with self._lock:
            if self._closed:
                return
            obj.setdefault("id", self._take_id())
            self._write(obj)
            if self._file_bytes >= self.rotate_bytes:
                self._open_next_file()

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    # -- public API ---------------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time a region; the record is written when the region exits."""
        stack = self._stack()
        with self._lock:
            sid = self._take_id()
        parent = stack[-1] if stack else None
        stack.append(sid)
        t0 = self._now()
        try:
            yield sid
        finally:
            dur = self._now() - t0
            stack.pop()
            rec = {"schema": OBS_SCHEMA, "pid": self.process_id,
                   "id": sid, "ts": t0, "ph": "span", "name": name,
                   "parent": parent, "dur_s": dur}
            if attrs:
                rec["attrs"] = attrs
            self._emit(rec)

    def event(self, name: str, **attrs) -> None:
        """A point event, attributed to this thread's open span."""
        stack = self._stack()
        rec = {"schema": OBS_SCHEMA, "pid": self.process_id,
               "ts": self._now(), "ph": "event", "name": name,
               "parent": stack[-1] if stack else None}
        if attrs:
            rec["attrs"] = attrs
        self._emit(rec)

    def flush(self) -> None:
        with self._lock:
            if self._file is not None and not self._closed:
                self._file.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "SpanTracer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _json_default(obj):
    """Last-resort encoder: never let a numpy scalar (or anything else
    JSON-foreign) kill the trace stream mid-fit. ``item()`` (the numpy
    scalar unboxing protocol) preserves int-ness; the float fallback
    must come before int, or float-like values would silently truncate."""
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            v = item()
            if isinstance(v, (bool, int, float, str)):
                return v
        except (TypeError, ValueError):
            pass
    for cast in (float, int):
        try:
            return cast(obj)
        except (TypeError, ValueError):
            continue
    return repr(obj)


# -- reader ------------------------------------------------------------------

def trace_files(trace_dir: Union[str, Path],
                process_id: Optional[int] = None) -> List[Path]:
    """The trace files of a directory, in (process, sequence) order."""
    pat = (f"{_FILE_PREFIX}*.jsonl" if process_id is None
           else f"{_FILE_PREFIX}{process_id:05d}-*.jsonl")
    return sorted(Path(trace_dir).glob(pat))


def read_events(trace_dir: Union[str, Path],
                process_id: Optional[int] = None) -> List[Dict[str, Any]]:
    """Merge every per-process file into one time-ordered event list.

    Events are ordered by wall-clock time: each file's ``meta`` record
    carries the process's wall epoch, so per-process monotonic offsets
    from different hosts interleave correctly (up to host clock skew).
    A schema newer than this reader understands is a loud error, not a
    silent mis-parse.
    """
    files = trace_files(trace_dir, process_id)
    if not files:
        raise FileNotFoundError(
            f"{trace_dir} holds no trace files ({_FILE_PREFIX}*.jsonl)")
    out: List[Dict[str, Any]] = []
    wall0: Dict[int, float] = {}
    for path in files:
        with open(path, encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{path}:{lineno}: corrupt trace line: {e}"
                        ) from None
                schema = rec.get("schema")
                if schema is not None and schema > OBS_SCHEMA:
                    raise ValueError(
                        f"{path}:{lineno}: trace schema {schema} is newer "
                        f"than this reader (understands <= {OBS_SCHEMA})")
                if rec.get("ph") == "meta":
                    wall0[rec.get("pid", 0)] = float(rec.get("wall0", 0.0))
                out.append(rec)
    out.sort(key=lambda r: (wall0.get(r.get("pid", 0), 0.0)
                            + float(r.get("ts", 0.0)),
                            r.get("pid", 0), r.get("id", 0)))
    return out


def tail_events(trace_dir: Union[str, Path], n: int = 20
                ) -> List[Dict[str, Any]]:
    """The last ``n`` merged events (cheap follower for live fits)."""
    return read_events(trace_dir)[-n:]


def summarize(events: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a merged event stream into one JSON-safe summary.

    Round-level scalars (k-scans, bytes, retraces) are aggregated from
    the LOWEST process id only: `RoundInfo` is psum-reduced before it
    lands, so every process reports the same global values and summing
    across processes would multiply the work by the process count.
    Span timings are aggregated per process — wall time is the one
    thing replication does NOT make identical.
    """
    events = list(events)
    pids = sorted({e.get("pid", 0) for e in events})
    lead = pids[0] if pids else 0
    rounds_by_pid = {p: 0 for p in pids}
    summary: Dict[str, Any] = {
        "schema": OBS_SCHEMA, "processes": pids,
        "rounds": 0, "kscans_total": 0, "dist_evals_total": 0,
        "bytes_total": 0, "overflow_retries": 0, "jit_traces": 0,
        "round_s_total": 0.0, "max_b_global": 0,
        "utilization_last": None, "val_mse_last": None,
        "spans": {},
    }
    spans: Dict[str, Dict[str, Any]] = {}
    for e in events:
        pid = e.get("pid", 0)
        name = e.get("name")
        attrs = e.get("attrs", {}) or {}
        if e.get("ph") == "span":
            key = f"p{pid}:{name}"
            s = spans.setdefault(key, {"count": 0, "total_s": 0.0,
                                       "max_s": 0.0})
            d = float(e.get("dur_s", 0.0))
            s["count"] += 1
            s["total_s"] += d
            s["max_s"] = max(s["max_s"], d)
            continue
        if e.get("ph") != "event":
            continue
        if name == "round":
            rounds_by_pid[pid] = rounds_by_pid.get(pid, 0) + 1
            if pid != lead:
                continue
            summary["rounds"] += 1
            summary["kscans_total"] += int(attrs.get("kscans", 0))
            summary["dist_evals_total"] += int(attrs.get("dist_evals", 0))
            summary["bytes_total"] += int(attrs.get("bytes", 0))
            summary["round_s_total"] += float(attrs.get("dt_s", 0.0))
            summary["max_b_global"] = max(summary["max_b_global"],
                                          int(attrs.get("b_global", 0)))
            if attrs.get("utilization") is not None:
                summary["utilization_last"] = attrs["utilization"]
            if attrs.get("val_mse") is not None:
                summary["val_mse_last"] = attrs["val_mse"]
        elif name == "jit_trace" and pid == lead:
            summary["jit_traces"] += int(attrs.get("n", 1))
        elif name == "overflow_retry" and pid == lead:
            summary["overflow_retries"] += 1
    summary["rounds_by_process"] = rounds_by_pid
    summary["spans"] = {k: {**v, "mean_s": v["total_s"] / v["count"]}
                        for k, v in sorted(spans.items())}
    if summary["rounds"]:
        summary["round_s_mean"] = (summary["round_s_total"]
                                   / summary["rounds"])
        if summary["round_s_total"] > 0:
            summary["kscans_per_s"] = (summary["kscans_total"]
                                       / summary["round_s_total"])
    return summary

"""One run of one cell: set-up, the measured window, the traced passes,
the check of the answers, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

* its configuration: the ``file`` of its entry in ``configs``, whose
  ``reference`` names the plain reference (``perfbench/reference/``);
* its traffic: ``perfbench/traffic/<traffic>.json``, whose ``kind`` names
  the loop (`perfbench.loops.LOOPS`);
* the limits its check holds each compared number to:
  ``perfbench/limits/<workload>.json``;
* each metric it reports: a reader ``perfbench/metrics/<metric>.py``
  with a function ``read(run)`` over the run's `Readings`, which returns
  a number, or None where it finds nothing to read.

A run with ``trace=0`` reports the cell's end-to-end metrics. A run with
``trace=1`` runs the same window, then an instrumented pass (each call
of the program's four kernel entry points in ``repro_torch.kernels.ops``
timed with CUDA events) and a profiled pass (`torch.profiler`), and
reports the cell's per-layer metrics.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench import loops, profiling

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
#: what no process that prints a result may hold, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload with its files resolved."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    def reference(self):
        return _load_module(
            BENCH / "reference" / f"{self.config['reference']}.py",
            f"perfbench_reference_{self.config['reference']}")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name: str, man: Optional[dict] = None,
         overrides: Optional[dict] = None) -> Cell:
    """The workload ``name`` of the manifest; ``overrides`` replaces keys
    of its configuration (the tests' small sizes)."""
    man = man or manifest()
    work = next((w for w in man["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == work["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    config.update(overrides or {})
    traffic = json.loads(
        (BENCH / "traffic" / f"{work['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layers = [m for m in man["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=work["chips"], config=config,
                traffic=traffic, limits=limits["limits"], end_to_end=e2e,
                per_layer=layers)


@dataclasses.dataclass
class Readings:
    """What a run measured, for the metric readers."""
    config: dict
    traffic: dict
    setup_s: float
    peak_bytes: int
    window_s: float
    units: List[dict]
    op_calls: List[dict] = dataclasses.field(default_factory=list)
    instrumented: List[dict] = dataclasses.field(default_factory=list)
    profile: Optional[dict] = None


def read_metrics(metrics: List[dict], run: Readings) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        reader = _load_module(BENCH / "metrics" / f"{m['name']}.py",
                              "perfbench_metric_" + m["name"].replace(
                                  ".", "_").replace("-", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def window(loop, seconds: float) -> tuple:
    """Units back to back until ``seconds`` have passed and the units
    make whole turns of ``loop.cycle``, at least one turn; the window
    ends with the last unit."""
    loop.keep = True
    units = []
    t0 = time.perf_counter()
    while True:
        units.append(loop.unit())
        if (time.perf_counter() - t0 >= seconds
                and len(units) % loop.cycle == 0):
            break
    loop.keep = False
    return units, time.perf_counter() - t0


def instrumented(loop, cuda: bool) -> tuple:
    """`loop.instrumented_units` units with every kernel entry point
    timed; each call's time and bound, each unit's wall and kernel time."""
    timer = profiling.OpTimer(cuda)
    units = []
    with timer:
        for _ in range(loop.instrumented_units):
            mark = len(timer.calls)
            rec = loop.unit()
            units.append((rec, mark, len(timer.calls)))
    calls = timer.results()
    out = []
    for rec, lo, hi in units:
        ops_ms = {}
        for c in calls[lo:hi]:
            ops_ms[c["op"]] = ops_ms.get(c["op"], 0.0) + c["ms"]
        out.append(dict(rec, ops_ms=ops_ms))
    return calls, out


def check(numbers: List[Dict[str, float]], limits: Dict[str, float]):
    """(correct, failed answers, {name: (largest value, limit)}): every
    number of every judged answer at most its limit. A number is held
    only where its limit is set; an answer judged by none is a failure."""
    worst: Dict[str, float] = {}
    failed = 0
    for nums in numbers:
        bad = not nums
        for name, value in nums.items():
            if name not in limits:
                continue
            worst[name] = max(worst.get(name, -math.inf), value)
            if not value <= limits[name]:       # NaN fails
                bad = True
        failed += bad
    table = {name: (worst[name], limits[name]) for name in worst}
    correct = bool(numbers) and failed == 0 and set(table) == set(limits)
    return correct, failed, table


def device_info(device, inputs_peak_bytes: int = 0) -> tuple:
    """The result line's ``device``, and the allocator's peak since the
    inputs were made (the program's, over warm-up and window). The
    line's ``memory_peak_bytes`` is the process's: the larger of that
    and the inputs' own peak."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}, 0
    peak = int(torch.cuda.max_memory_allocated(dev))
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(dev),
            "count": 1,
            "memory_peak_bytes": max(peak, inputs_peak_bytes)}, peak


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: Optional[float] = None,
        overrides: Optional[dict] = None, log=print) -> dict:
    """One run of ``workload``; returns the result line's object. ``log``
    takes the lines that go to standard error."""
    t_start = time.perf_counter() if t_start is None else t_start
    c = cell(workload, overrides=overrides)
    ref = c.reference()
    lp = loops.LOOPS[c.traffic["kind"]](c.config, c.traffic, seed,
                                             device, ref)
    cuda = torch.device(device).type == "cuda"
    lp.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    units, window_s = window(lp, seconds)
    dev, peak = device_info(device, lp.inputs_peak_bytes)
    log(f"window: {len(units)} units in {window_s!r} s; set-up "
        f"{setup_s!r} s; peak {peak} B since the inputs were made, "
        f"{lp.inputs_peak_bytes} B while they were made")
    walls = sorted(u["wall_s"] for u in units)
    log(f"unit walls: min {walls[0]!r}, median {statistics.median(walls)!r}"
        f", max {walls[-1]!r} s; per unit: " + ", ".join(
            f"{k} {statistics.fmean(float(u[k]) for u in units)!r}"
            for k in units[0] if k != "wall_s"))
    log("unit walls in order: " + " ".join(repr(u["wall_s"]) for u in units))

    readings = Readings(config=c.config, traffic=c.traffic,
                        setup_s=setup_s,
                        peak_bytes=peak,
                        window_s=window_s, units=units)
    breakdown = None
    if trace:
        readings.op_calls, readings.instrumented = instrumented(lp, cuda)
        readings.profile = profiling.profiled(lp, cuda)
        if readings.profile is not None:
            dev["busy_s"] = readings.profile["busy_s"]
            dev["window_s"] = readings.profile["window_s"]
            breakdown = {"device_ops": readings.profile["device_ops"],
                         "idle_gaps": readings.profile["idle_gaps"]}
    metrics = read_metrics(c.per_layer if trace else c.end_to_end,
                           readings)
    for name, m in metrics.items():
        log(f"metric {name}: {m['value']!r} {m['unit']}")
    if cuda:
        dev["power_limit_w"] = power_limit_w()

    lp.release()
    numbers = lp.judge()
    correct, failed, table = check(numbers, c.limits)
    for i, nums in enumerate(numbers):
        log(f"judged answer {i}: " + ", ".join(
            f"{k} {v!r}" for k, v in nums.items()))
    out = {"correct": correct, "attempted": len(units), "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, (v, lim) in table.items()}
    for name, (v, lim) in table.items():
        log(f"check {name}: {v!r} (limit {lim!r})")
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    def err(line):
        print(line, file=sys.stderr, flush=True)

    need = cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        err(f"needs {need} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() is "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 t_start=t_start, log=err)
    found = forbidden_modules()
    if found:
        err(f"the run's process holds {found}: the benchmark measures the "
            f"port alone")
        return 3
    # the compared numbers are the last lines on standard error
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


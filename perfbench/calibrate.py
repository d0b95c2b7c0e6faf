"""Read a cell's compared numbers over many seeds of the program and of
its control, in one process, to set the cell's limits from.

    python3 perfbench/calibrate.py --workload kmeans_xl.dp_round \
        --seeds 101,102,103 --control-seeds 201,202,203 --seconds 3 \
        --out calibrate.json

For each seed of ``--seeds`` the cell's loop makes the seed's inputs,
runs its timed path for a short window at the cell's own sizes and
judges the window's answers as a run does. For each seed of
``--control-seeds`` it makes the inputs and judges the control in the
program's place (`perfbench.loops.Loop.control`). The largest number
a seed gives, by name, is written to ``--out`` and summed up on standard
output: the program's largest over its seeds (the lower reading) and the
control's smallest (the upper one). The benchmark's runs never run this.
"""
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness, loops  # noqa: E402


def _largest(numbers):
    out = {}
    for nums in numbers:
        for k, v in nums.items():
            out[k] = max(out.get(k, float("-inf")), v)
    return out


def readings(workload: str, seeds, control_seeds, seconds: float,
             device="cuda", overrides=None, log=print) -> dict:
    c = harness.cell(workload, overrides=overrides)
    ref = c.reference()
    got = {"program": {}, "control": {}}
    for role, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            lp = loops.LOOPS[c.traffic["kind"]](
                c.config, c.traffic, seed, device, ref)
            lp.setup()
            if role == "program":
                units, _ = harness.window(lp, seconds)
                lp.release()
                nums = _largest(lp.judge())
            else:
                nums = _largest(lp.control())
            got[role][str(seed)] = nums
            log(f"{role} seed {seed} ({time.perf_counter() - t0:.1f} s): "
                + ", ".join(f"{k} {v!r}" for k, v in nums.items()))
            del lp
            gc.collect()
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    names = sorted({k for r in got.values() for nums in r.values()
                    for k in nums})
    summary = {}
    for k in names:
        low = max((n[k] for n in got["program"].values() if k in n),
                  default=None)
        up = min((n[k] for n in got["control"].values() if k in n),
                 default=None)
        summary[k] = {"program_max": low, "control_min": up}
        log(f"{k}: program max {low!r}, control min {up!r}, ratio "
            f"{(up / low) if low and up else None!r}")
    got["summary"] = summary
    return got


def main() -> int:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    got = readings(a.workload, seeds(a.seeds), seeds(a.control_seeds),
                   a.seconds, log=lambda line: print(line, flush=True))
    got["device"] = torch.cuda.get_device_name(0)
    got["power_limit_w"] = harness.power_limit_w()
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps(got, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one benchmark cell once and print its result as the last line.

    python3 perfbench/run.py --workload infmnist.fit --seed 7 \
        --seconds 40 --trace 0

Run from the root of a checkout that holds ``src/repro_torch`` beside
this folder. Exits 2 without a result where there are not as many CUDA
devices as the cell asks for, and 3 where the process holds JAX or the
JAX package once the window has closed.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))

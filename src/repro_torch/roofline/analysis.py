"""Two-term roofline of one NVIDIA H100 SXM (80 GB HBM3, 700 W).

Port of `Roofline` and `roofline_terms` from `repro/roofline/analysis.py`,
whose constants are TPU v5e's and are not reused:

  compute term  = f32 FLOPs / 67 TFLOP/s  +  TF32 FLOPs / 495 TFLOP/s
  memory term   = bytes / 3.35 TB/s

The rates are NVIDIA's data-sheet peaks of the SXM part at its full 700 W
power limit, dense, without sparsity: 67 TFLOP/s in f32 on the CUDA cores,
495 TFLOP/s in TF32 on the tensor cores, 3.35 TB/s of HBM3. A card set
below 700 W runs slower under load, so a share of this bound is stated
with the card's power limit beside it. The port's f32 top-2s run as three
TF32 products a pair (3xTF32), priced at the TF32 rate.

There is no link term: one card has no collective traffic, and the
sharded engines' all-reduce over NVLink across cards is not measured yet
(PERF.md §7). The HLO parsing of the reference (and `roofline/hlo_cost.py`) has no
counterpart here.
"""
from __future__ import annotations

import dataclasses

#: H100 SXM HBM3 bytes a second
PEAK_BYTES_S = 3.35e12
#: H100 SXM f32 FLOP/s on the CUDA cores (no tensor cores)
PEAK_F32_FLOPS = 67e12
#: H100 SXM TF32 FLOP/s on the tensor cores, dense
PEAK_TF32_FLOPS = 495e12


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: float           # f32 FLOPs on the CUDA cores
    tf32_flops: float      # TF32 FLOPs on the tensor cores
    hbm_bytes: float
    compute_s: float
    memory_s: float
    bottleneck: str        # "compute" | "memory"

    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: the larger of the two terms."""
        return max(self.compute_s, self.memory_s)


def roofline_terms(flops: float, hbm_bytes: float, *,
                   tf32_flops: float = 0.0) -> Roofline:
    """The bound of work that does ``flops`` f32 operations on the CUDA
    cores, ``tf32_flops`` TF32 operations on the tensor cores and moves
    ``hbm_bytes`` (each input read once, each output written once)."""
    c = flops / PEAK_F32_FLOPS + tf32_flops / PEAK_TF32_FLOPS
    m = hbm_bytes / PEAK_BYTES_S
    return Roofline(flops=flops, tf32_flops=tf32_flops,
                    hbm_bytes=hbm_bytes, compute_s=c, memory_s=m,
                    bottleneck="memory" if m >= c else "compute")

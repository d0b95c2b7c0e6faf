"""Three-term roofline of one NVIDIA H100 SXM (80 GB HBM3, 700 W).

Port of `repro/roofline/analysis.py`, whose constants are TPU v5e's and
are not reused:

  compute term    = f32 FLOPs / 67 TFLOP/s + TF32 FLOPs / 495 TFLOP/s
                    + bf16 FLOPs / 989 TFLOP/s
  memory term     = bytes / 3.35 TB/s
  collective term = NVLink wire bytes / 450 GB/s
                    + network wire bytes / 50 GB/s

The rates are NVIDIA's data-sheet peaks of the SXM part at its full 700 W
power limit, dense, without sparsity: 67 TFLOP/s in f32 on the CUDA cores,
495 TFLOP/s in TF32 and 989 TFLOP/s in bf16 on the tensor cores, 3.35 TB/s
of HBM3, 450 GB/s a direction of NVLink 4 between the cards of one 8-card
node, and 50 GB/s, one 400 Gb/s NDR NIC, for a collective whose ranks
span nodes (a rank's node is ``rank // 8``). None is measured. A card set
below 700 W runs slower under load, so a share of this bound is stated
with the card's power limit beside it. The port's f32 top-2s run as three
TF32 products a pair (3xTF32), priced at the TF32 rate; its f32 products
of bf16-rounded operands (the attention's scores, the experts, the SSD)
run with TF32 off, on the CUDA cores, at the f32 rate.

Wire bytes are JAX's ring estimates (large-n approximation), per device:

  all-gather          its output        (each rank receives ~out)
  reduce-scatter      its input         (each rank sends ~in)
  all-reduce          2 x its output    (reduce-scatter + all-gather)
  all-to-all          its output
  collective-permute  its output        (one hop)

JAX parses them out of partitioned HLO (`parse_collectives`); the port
has no HLO, and `repro_torch.roofline.op_cost` sums them over the c10d
collectives a traced rank issues.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

#: H100 SXM HBM3 bytes a second
PEAK_BYTES_S = 3.35e12
#: H100 SXM f32 FLOP/s on the CUDA cores (no tensor cores)
PEAK_F32_FLOPS = 67e12
#: H100 SXM TF32 FLOP/s on the tensor cores, dense
PEAK_TF32_FLOPS = 495e12
#: H100 SXM bf16 FLOP/s on the tensor cores, dense
PEAK_BF16_FLOPS = 989e12
#: NVLink 4 bytes a second a direction, between the cards of one node
NVLINK_BYTES_S = 450e9
#: one 400 Gb/s NDR NIC, bytes a second, for a collective across nodes
NET_BYTES_S = 50e9
#: cards a node: the ranks ``8 n .. 8 n + 7`` share NVLink
CARDS_PER_NODE = 8

#: wire bytes of a collective of each kind, as a multiple of its moved
#: buffer (the output; the input of a reduce-scatter)
WIRE_FACTOR = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-reduce": 2.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0
    by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, b: float):
        self.wire_bytes += b
        self.by_kind[kind] = self.by_kind.get(kind, 0.0) + b
        self.counts[kind] = self.counts.get(kind, 0) + 1


def spans_nodes(ranks: Iterable[int]) -> bool:
    """Do a group's global ranks lie on more than one node?"""
    return len({int(r) // CARDS_PER_NODE for r in ranks}) > 1


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: float           # f32 FLOPs on the CUDA cores
    tf32_flops: float      # TF32 FLOPs on the tensor cores
    hbm_bytes: float
    compute_s: float
    memory_s: float
    bottleneck: str        # "compute" | "memory" | "collective"
    bf16_flops: float = 0.0      # bf16 FLOPs on the tensor cores
    wire_bytes: float = 0.0      # NVLink + network wire bytes
    collective_s: float = 0.0
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None

    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: the largest of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> Optional[float]:
        """useful FLOPs at the bf16 peak over the bound: the MFU-style
        score (JAX's, at the H100's bf16 rate)."""
        if not self.model_flops:
            return None
        t = self.step_time_s()
        return (self.model_flops / PEAK_BF16_FLOPS) / t if t > 0 else None


def roofline_terms(flops: float, hbm_bytes: float, *,
                   tf32_flops: float = 0.0, bf16_flops: float = 0.0,
                   nvlink_bytes: float = 0.0, net_bytes: float = 0.0,
                   model_flops: Optional[float] = None) -> Roofline:
    """The bound of work that does ``flops`` f32 operations on the CUDA
    cores, ``tf32_flops`` TF32 and ``bf16_flops`` bf16 operations on the
    tensor cores, moves ``hbm_bytes`` (each input read once, each output
    written once) and sends ``nvlink_bytes`` within a node and
    ``net_bytes`` across nodes. ``model_flops``: the useful FLOPs (JAX's
    ``model_flops``), for ``useful_ratio`` and ``roofline_fraction``.
    With the new arguments at their defaults the terms are the two-term
    bound's."""
    c = (flops / PEAK_F32_FLOPS + tf32_flops / PEAK_TF32_FLOPS
         + bf16_flops / PEAK_BF16_FLOPS)
    m = hbm_bytes / PEAK_BYTES_S
    x = nvlink_bytes / NVLINK_BYTES_S + net_bytes / NET_BYTES_S
    dom = "memory" if m >= c else "compute"
    if x > max(c, m):
        dom = "collective"
    total = flops + tf32_flops + bf16_flops
    useful = (model_flops / total) if (model_flops and total) else None
    return Roofline(flops=flops, tf32_flops=tf32_flops, hbm_bytes=hbm_bytes,
                    compute_s=c, memory_s=m, bottleneck=dom,
                    bf16_flops=bf16_flops,
                    wire_bytes=nvlink_bytes + net_bytes, collective_s=x,
                    model_flops=model_flops, useful_ratio=useful)


def model_flops_train(active_params: int, tokens: int) -> float:
    """6 N D (fwd 2ND + bwd 4ND), MoE: N = active params."""
    return 6.0 * active_params * tokens


def model_flops_fwd(active_params: int, tokens: int) -> float:
    return 2.0 * active_params * tokens

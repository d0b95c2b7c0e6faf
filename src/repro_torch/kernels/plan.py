"""Kernel dispatch: one resolved `KernelPlan` per fit.

Port of `repro/kernels/plan.py`. An engine calls `resolve_plan` once per
fit and passes the frozen result to every op that may launch a kernel.

  kernel_backend  None  the hand kernels ("cuda") for a CUDA device,
                        the plain versions ("ref") for the CPU
                  "ref"   the plain versions on any device
                  "cuda"  the hand kernels; refused for a CPU device

The kernels' tiles are fixed in their sources (`kernels/csrc`). The one
size chosen per call is the row chunk of the deterministic reductions
(`chunk_rows`), from a small table keyed on the call's row count: the
chunk count, and so the order of every float sum, depends on the shape
alone and never on the device. There is no tuning path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

BACKENDS = ("ref", "cuda")

#: most row chunks a deterministic reduction splits its rows into, and
#: the fewest rows a chunk holds
MAX_CHUNKS = 256
MIN_CHUNK_ROWS = 256


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, int(x) - 1).bit_length()


def chunk_rows(n: int) -> int:
    """Rows per chunk of a deterministic reduction over ``n`` rows."""
    return max(MIN_CHUNK_ROWS, next_pow2(n) // MAX_CHUNKS)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Resolved kernel dispatch for one fit (frozen and hashable)."""

    backend: str                    # "ref" | "cuda"
    bucket: Tuple[int, int, int]    # pow2 (b, k, d) lattice cell
    family: str = "unset"           # bound family the plan serves

    def to_dict(self) -> Dict[str, Any]:
        """JSON form for manifests and `FitOutcome.kernel_plan`."""
        return {"backend": self.backend, "bucket": list(self.bucket),
                "family": self.family}


def resolve_plan(kernel_backend: Optional[str] = None, *, b: int, k: int,
                 d: int, device: Any = "cuda",
                 bounds: Optional[str] = None) -> KernelPlan:
    """Resolve ``config.kernel_backend`` for a fit on ``device``."""
    if kernel_backend not in (None,) + BACKENDS:
        raise ValueError(f"unknown kernel_backend {kernel_backend!r}; "
                         f"expected None or one of {BACKENDS}")
    dev = torch.device(device)
    if kernel_backend is None:
        kernel_backend = "cuda" if dev.type == "cuda" else "ref"
    if kernel_backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"kernel_backend='cuda' needs a CUDA device, got {dev}")
    return KernelPlan(backend=kernel_backend,
                      bucket=(next_pow2(b), next_pow2(k), next_pow2(d)),
                      family=bounds or "unset")

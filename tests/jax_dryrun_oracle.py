"""The JAX package's dry run of reduced cells on forced host devices: the
oracle of tests/test_torch_dryrun.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/jax_dryrun_oracle.py OUT.json

For each of `DRY_CELLS` (an architecture at --reduced size and a small
shape) on a (2, 2) ("data", "model") mesh of the 4 devices, it runs
`repro.launch.dryrun.lower_cell`, compiles the step with its
in_shardings, and writes to OUT.json what `run_cell` reads from it:
`hlo_cost.analyze`'s per-device FLOPs, bytes and wire bytes by kind,
`parse_collectives`' counts, and the model FLOPs per device. The mesh is
built by `repro.launch.mesh._make_mesh` (Auto axes: `jax.make_mesh`'s
Explicit axes make `with_sharding_constraint` assert).
"""
from __future__ import annotations

import json
import sys

import jax

# the 4 devices come up before repro.launch.dryrun's import asks for 512
jax.devices()

from repro import configs  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch import dryrun  # noqa: E402
from repro.launch.mesh import _make_mesh  # noqa: E402
from repro.roofline import analysis as ra  # noqa: E402
from repro.roofline import hlo_cost  # noqa: E402

#: (arch, kind) cells; every shape is seq `DRY_SEQ`, batch `DRY_BATCH`
DRY_CELLS = [(arch, kind) for arch in ("tinyllama-1.1b",
                                       "granite-moe-1b-a400m",
                                       "mamba2-2.7b")
             for kind in ("train", "prefill", "decode")]
DRY_SEQ, DRY_BATCH, DRY_MESH = 64, 4, (2, 2)


def shape_of(kind: str) -> ShapeConfig:
    return ShapeConfig(f"{kind}_r", DRY_SEQ, DRY_BATCH, kind)


def main(out: str) -> None:
    mesh = _make_mesh(DRY_MESH, ("data", "model"))
    n = len(jax.devices())
    rec = {}
    for arch, kind in DRY_CELLS:
        cfg = configs.get_reduced(arch)
        fn, args, in_sh, model_flops = dryrun.lower_cell(
            cfg, shape_of(kind), mesh)
        with jax.set_mesh(mesh):
            hlo = jax.jit(fn, in_shardings=in_sh).lower(*args) \
                .compile().as_text()
        hc = hlo_cost.analyze(hlo)
        rec[f"{arch}:{kind}"] = {
            "flops": hc.flops, "bytes": hc.bytes, "wire": hc.wire,
            "wire_by_kind": hc.wire_by_kind,
            "counts": ra.parse_collectives(hlo).counts,
            "model_flops_per_device": model_flops / n}
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1])

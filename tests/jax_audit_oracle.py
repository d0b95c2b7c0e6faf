"""The JAX package's runtime audits and int8 compressed sum on forced
host devices: the oracle of tests/test_torch_analysis.py and
tests/test_torch_train.py.

    python tests/jax_audit_oracle.py WORKDIR N [BACKENDS]

It runs in a process of its own, with N forced host devices (the test
process must see the one real CPU device, tests/conftest.py). For each
of the comma-separated BACKENDS it runs `repro.analysis.retrace
.audit_backend` (JAX's default fit, over every device) and records the
(b, capacity) buckets the fit invoked, sorted, into
``WORKDIR/jax_audit_<N>.json`` with the audit's violations' count. Where
``WORKDIR/compress.npz`` holds ``g`` and ``e`` (N, ...) stacks, it also
runs `repro.optim.compression.compressed_psum` over N devices, device i
holding ``g[i]`` and ``e[i]``, and writes each device's sum and error to
``WORKDIR/jax_compress.npz``.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path


def main(workdir: str, n: int, backends: str = "") -> None:
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
    import jax
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    import repro.api.loop as jloop
    from repro.analysis import retrace
    from repro.core.distributed import shard_map_compat
    from repro.optim import compression

    wd = Path(workdir)
    assert len(jax.devices()) == n, jax.devices()
    invoked = {}
    run_loop = jloop.run_loop

    def recording(run, config, **kw):
        seen = invoked.setdefault(config.backend, set())
        step = run.nested_step

        def logged(state, b, capacity):
            seen.add((b, capacity))
            return step(state, b, capacity)

        run.nested_step = logged
        return run_loop(run, config, **kw)

    jloop.run_loop = recording
    out = {}
    for b in filter(None, backends.split(",")):
        found = retrace.audit_backend(b)
        out[b] = {"violations": len(found),
                  "invoked": sorted(invoked[b],
                                    key=lambda t: (t[0], t[1] or 0))}
    (wd / f"jax_audit_{n}.json").write_text(json.dumps(out))

    if (wd / "compress.npz").exists():
        inp = np.load(wd / "compress.npz")
        mesh = Mesh(np.array(jax.devices()), ("pod",))

        def body(g, e):
            s, err = compression.compressed_psum({"g": g[0]}, {"g": e[0]},
                                                 "pod")
            return s["g"][None], err["g"][None]

        fn = shard_map_compat(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                              out_specs=(P("pod"), P("pod")))
        s, err = jax.jit(fn)(inp["g"], inp["e"])
        np.savez(wd / "jax_compress.npz", s=np.asarray(s),
                 err=np.asarray(err))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), *sys.argv[3:])

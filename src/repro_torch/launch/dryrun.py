"""Multi-pod dry run: trace one rank of every (arch x shape x mesh) cell.

Port of `repro/launch/dryrun.py`. JAX lowers and compiles each cell on
512 placeholder host devices and reads the partitioned HLO. The port's
sharded steps are explicit collectives over each rank's blocks, so the
counterpart runs rank 0 of a fake process group of 256 (pod16x16) or 512
(pod2x16x16) ranks (`launch.mesh.init_fake_group`, started by `main`
only: importing this module starts no group) under ``FakeTensorMode``,
on the blocks that `sharding.param_specs`/`batch_specs`/`cache_specs`
cut from the abstract params and inputs, and counts what that rank does
with `repro_torch.roofline.op_cost`. Nothing is allocated and no card is
needed. For each cell, ``artifacts/dryrun_torch/<cell>.json`` holds:

  * per-device FLOPs (by compute dtype), bytes and collective wire bytes
    by kind, and the collectives' counts;
  * ``memory``: the analytic storage of the arguments (JAX's
    ``_dev_bytes``) and the traced peak live bytes, against the H100's
    80 GB (``fits_hbm``);
  * the three-term roofline at the H100 SXM's data-sheet rates
    (`repro_torch.roofline.analysis`): bounds, not measurements;
  * ``t_trace_s`` in place of JAX's ``t_lower_s``/``t_compile_s``.

JAX's ``xla_cost_analysis`` (XLA's own count, which takes a while body
once) has no counterpart: the port's count is the only one. A step's
microbatches and periods repeat the same ops on the same shapes, so, as
JAX's cost model multiplies a loop's body by its trips, the train step's
microbatch loop runs one trip counted ``n_micro`` times (`op_cost.loop`),
and each cell is traced at two and three periods and the count extended
to the cell's (`op_cost.extrapolate`); the encdec family, whose encoder
is a stack of its own, is traced whole.

The kmeans cells trace `core/distributed.py`'s round with the plain plan
(`make_dp_round` for kmeans_xl, whose centroids are replicated; else
`make_sharded_round`): a hand kernel launched through ``ctypes`` cannot
run on fake tensors, as JAX's Pallas kernel cannot appear in CPU HLO.
Beside the trace they record ``kernel_analytic``, the traffic and
operations of the port's kernel 4 (`ops.fused_round`: X once, C and the
outputs; the top-2 as three TF32 products a pair, the adds into S in
f32), as PERF.md's kernel table reckons its bound. JAX's
``pallas_analytic`` also counts a one-hot S product (2 n k d); the
port's kernel scatters the rows into S and does no such product.

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--kmeans]
  python -m repro_torch.launch.dryrun --arch ... --shape ... --dump-ops f.tsv
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import input_specs as ispec
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.optim import adamw
from repro_torch.roofline import analysis as ra
from repro_torch.roofline import op_cost
from repro_torch.train import step as tstep

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
#: HBM of one H100 SXM 80 GB, bytes
HBM_BYTES = 80e9


def _mesh_tag(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def n_micro_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """One sequence per data shard per microbatch."""
    dp = S.axis_size(mesh, S.data_axes(mesh))
    return max(1, shape.global_batch // dp)


def _rows_sharded(mesh, batch: int) -> bool:
    return batch % S.axis_size(mesh, S.data_axes(mesh)) == 0


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               remat: bool = True):
    """(step, abstract args, their specs, model FLOPs) of one cell: the
    counterpart of JAX's ``lower_cell``. The args are meta tensors at the
    global shapes; each rank's step takes the blocks the specs cut.
    ``remat``: the train step's recompute of each period."""
    params_s = ispec.abstract_params(cfg)
    pspecs = S.param_specs(cfg, mesh, params_s)
    if shape.kind == "train":
        n_micro = n_micro_for(cfg, shape, mesh)
        batch_s = ispec.train_batch_specs(cfg, shape)
        opt_s = ispec.abstract_opt_state(params_s)
        fn = tstep.make_train_step(
            cfg, n_micro=n_micro, mesh=mesh, device="cpu", remat=remat,
            accum_dtype=(torch.bfloat16 if cfg.param_count() > 1e11
                         else torch.float32))
        args = (params_s, opt_s, batch_s)
        specs = (pspecs, adamw.AdamWState(mu=pspecs, nu=pspecs, count=()),
                 S.batch_specs(cfg, mesh, batch_s))
        tokens = shape.global_batch * shape.seq_len
        model_flops = ra.model_flops_train(cfg.active_param_count(), tokens)
    elif shape.kind == "prefill":
        batch_s = ispec.prefill_batch_specs(cfg, shape)
        fn = tstep.make_prefill_step(
            cfg, cache_len=shape.seq_len, mesh=mesh, device="cpu",
            rows_sharded=_rows_sharded(mesh, shape.global_batch))
        args = (params_s, batch_s)
        specs = (pspecs, S.batch_specs(cfg, mesh, batch_s))
        tokens = shape.global_batch * shape.seq_len
        model_flops = ra.model_flops_fwd(cfg.active_param_count(), tokens)
    else:  # decode
        dec = ispec.decode_specs(cfg, shape)
        rows = _rows_sharded(mesh, shape.global_batch)
        fn = tstep.make_decode_step(cfg, mesh=mesh, rows_sharded=rows,
                                    device="cpu")
        args = (params_s, dec["token"], dec["cache"])
        specs = (pspecs, S._spec(S.data_axes(mesh) if rows else None, None),
                 S.cache_specs(cfg, mesh, dec["cache"]))
        tokens = shape.global_batch            # one token per sequence
        model_flops = ra.model_flops_fwd(cfg.active_param_count(), tokens)
    return fn, args, specs, model_flops


def _blocks(tree, specs, mesh):
    """This rank's fake block of each meta leaf of ``tree`` (call under
    ``FakeTensorMode``)."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(_blocks(t, s, mesh) for t, s in zip(tree, specs))
    if isinstance(tree, adamw.AdamWState):
        return adamw.AdamWState(*(_blocks(t, s, mesh)
                                  for t, s in zip(tree, specs)))
    if isinstance(tree, dict):
        return {k: _blocks(v, specs[k], mesh) for k, v in tree.items()}
    return torch.zeros(S.block_shape(tree.shape, specs, mesh),
                       dtype=tree.dtype)


def _dev_bytes(args, specs, mesh) -> int:
    """JAX's analytic per-device storage of the arguments: each leaf's
    bytes over the ranks of every axis that divides its dim."""
    total = 0

    def walk(t, s):
        nonlocal total
        if isinstance(t, (tuple, list)) and not isinstance(t, torch.Tensor):
            for a, b in zip(t, s):
                walk(a, b)
            return
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
            return
        n = t.numel() * t.element_size()
        for dim, ax in enumerate(s):
            if ax is None:
                continue
            size = S.axis_size(mesh, S._entry_axes(ax))
            if t.shape[dim] % size == 0:
                n //= size
        total += n
    walk(args, specs)
    return total


def _trace(cfg, shape, mesh, keep_ops=False, remat=True, fold=True):
    """One trace of rank 0's step (``fold``: its microbatches folded into
    one traced trip, `op_cost.loop`): (its cost, the mode, model FLOPs,
    the args, their specs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fn, args, specs, mf = trace_cell(cfg, shape, mesh, remat=remat)
    with FakeTensorMode():
        blocks = _blocks(args, specs, mesh)
        cost, out, mode = op_cost.analyze(fn, *blocks, keep_ops=keep_ops,
                                          fold=fold)
        del out, blocks
    return cost, mode, mf, args, specs


def _periods_cfg(cfg: ModelConfig, n: int) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=M.period_len(cfg) * n)


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
              keep_ops: bool = False):
    """(the cell's per-device `OpCost`, the traced mode, model FLOPs,
    args, specs): the train step's microbatches folded into one traced
    trip (`op_cost.loop`), and the step traced at two and three periods
    and extended to the cell's (`op_cost.extrapolate`; the first
    period's increment of the peak is not the others'); the encdec
    family and a stack of three periods or fewer traced whole."""
    n_per = M.n_periods(cfg)
    if cfg.family == "encdec" or n_per <= 3:
        cost, mode, *_ = _trace(cfg, shape, mesh, keep_ops=keep_ops)
    else:
        c2, mode, *_ = _trace(_periods_cfg(cfg, 2), shape, mesh,
                              keep_ops=keep_ops)
        c3 = _trace(_periods_cfg(cfg, 3), shape, mesh)[0]
        cost = op_cost.extrapolate(c2, c3, n_per, at=2)
    # the args and specs at the cell's full size (for the storage)
    _, args, specs, mf = trace_cell(cfg, shape, mesh)
    return cost, mode, mf, args, specs


def _roof(cost: op_cost.OpCost, model_flops: Optional[float]):
    by = cost.flops_by_dtype
    return ra.roofline_terms(by.get("f32", 0.0), cost.bytes,
                             bf16_flops=by.get("bf16", 0.0),
                             nvlink_bytes=cost.nvlink_wire,
                             net_bytes=cost.net_wire,
                             model_flops=model_flops)


def _roof_dict(r) -> dict:
    return {"compute_s": r.compute_s, "memory_s": r.memory_s,
            "collective_s": r.collective_s, "bottleneck": r.bottleneck,
            "useful_ratio": r.useful_ratio,
            "roofline_fraction": r.roofline_fraction()}


def _world(mesh) -> int:
    return math.prod(S.describe(mesh).sizes)


def _write(rec: dict, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{rec['cell']}.json").write_text(json.dumps(rec, indent=1))


def run_cell(arch: str, shape: ShapeConfig, *, multi_pod: bool,
             out_dir: Path = ARTIFACTS, dump_ops: Optional[str] = None,
             tag: str = "") -> dict:
    """Trace one cell on rank 0 of the fake group (which must be up with
    the mesh's ranks: `main` starts it) and write its record."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = configs.get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    desc = S.describe(mesh)
    cell = f"{arch}__{shape.name}__{_mesh_tag(multi_pod)}{tag}"
    t0 = time.time()
    rec: dict = {"cell": cell, "arch": arch, "shape": shape.name,
                 "mesh": list(desc.sizes), "axes": list(desc.axis_names),
                 "kind": shape.kind}
    try:
        cost, mode, model_flops, args, specs = cell_cost(
            cfg, shape, mesh, keep_ops=bool(dump_ops))
        if dump_ops:
            op_cost.dump_ops(mode, dump_ops)
        n_chips = _world(mesh)
        mf = model_flops / n_chips
        roof = _roof(cost, mf)
        storage = _dev_bytes(args, specs, mesh)
        rec.update({
            "ok": True,
            "t_trace_s": round(time.time() - t0, 2),
            "flops_per_device": cost.flops,
            "flops_by_dtype": cost.flops_by_dtype,
            "hbm_bytes_per_device": cost.bytes,
            "wire_bytes_per_device": cost.wire,
            "net_wire_bytes_per_device": cost.net_wire,
            "collectives": cost.wire_by_kind,
            "collective_counts": cost.counts,
            "model_flops_per_device": mf,
            "memory": {"storage_bytes_analytic": storage,
                       "peak_bytes": cost.peak_bytes,
                       "fits_hbm": cost.peak_bytes <= HBM_BYTES,
                       "source": "op_cost (fake tensors)"},
            "roofline": _roof_dict(roof),
        })
    except Exception as e:
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    _write(rec, out_dir)
    print(_line(rec), flush=True)
    return rec


def _line(rec: dict) -> str:
    """The record's one line, as JAX prints it."""
    status = "OK " if rec.get("ok") else "FAIL"
    roofstr = ""
    if rec.get("ok"):
        r = rec["roofline"]
        peak = rec.get("memory", {}).get("peak_bytes")
        roofstr = (f" comp={r['compute_s']:.3g}s mem={r['memory_s']:.3g}s"
                   f" coll={r['collective_s']:.3g}s -> {r['bottleneck']}"
                   + (f" | peak/dev={peak / 1e9:.2f}GB" if peak else "")
                   + f" flops/dev={rec['flops_per_device']:.3g}")
    return f"[{status}] {rec['cell']}{roofstr}"


def kernel_analytic(n: int, d: int, k: int) -> dict:
    """The traffic and operations of the port's kernel 4
    (`ops.fused_round`) on ``n`` rows: X once, C, the labels and two
    distances out (12 B a row), S, v and sse out; the top-2's products as
    three TF32 products a pair (3xTF32), the adds into S in f32."""
    n_bytes = n * d * 4 + k * d * 4 + n * 12 + (k * d + 2 * k) * 4
    r = ra.roofline_terms(1.0 * n * d, n_bytes,
                          tf32_flops=3 * 2.0 * n * k * d)
    return {"hbm_bytes": n_bytes, "f32_flops": 1.0 * n * d,
            "tf32_flops": 3 * 2.0 * n * k * d,
            "bound_ms": r.step_time_s() * 1e3, "bottleneck": r.bottleneck,
            "note": "kernel 4 (fused_round): X once + C + outputs"}


def _abstract_kmeans_state(n: int, d: int, k: int):
    from repro_torch.core.state import ClusterStats, KMeansState, PointState
    z = torch.zeros
    return KMeansState(
        stats=ClusterStats(C=z((k, d)), S=z((k, d)), v=z((k,)),
                           sse=z((k,)), p=z((k,))),
        points=PointState(a=z((n,), dtype=torch.int32), d=z((n,)),
                          lb=z((n,))),
        elkan=None, round=z((), dtype=torch.int32))


def run_kmeans_cell(name: str, *, multi_pod: bool,
                    out_dir: Path = ARTIFACTS) -> dict:
    """The paper's own technique at production scale: one round on rank
    0's rows, traced with the plain plan (see the module's docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core import distributed as kd
    from repro_torch.kernels.plan import resolve_plan
    from repro_torch.launch.mesh import make_production_mesh
    kcfg = configs.get_kmeans_config(name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    desc = S.describe(mesh)
    cell = f"{name}__round__{_mesh_tag(multi_pod)}"
    dp_axes = tuple(a for a in desc.axis_names if a != "model")
    n_dp = S.axis_size(mesh, dp_axes)
    n_chips = _world(mesh)
    t0 = time.time()
    rec: dict = {"cell": cell, "arch": name, "shape": "round",
                 "mesh": list(desc.sizes), "axes": list(desc.axis_names),
                 "kind": "kmeans"}
    try:
        N, d, k = kcfg.n_points, kcfg.dim, kcfg.k
        N += -N % n_dp                   # structural tail padding
        n_local = N // n_dp
        b_local = max(1, min(kcfg.b0 * 64, N) // n_dp)
        with FakeTensorMode():
            if kcfg.shard_centroids:
                N += -N % n_chips
                n_loc = N // n_chips
                fn = kd.make_dp_round(mesh, rho=kcfg.rho)
                args = (torch.zeros((n_loc, d)), torch.zeros((k, d)))
                rec["kernel_analytic"] = kernel_analytic(n_loc, d, k)
            else:
                plan = resolve_plan("ref", b=b_local, k=k, d=d,
                                    device="cpu", bounds=kcfg.bounds)
                fn = kd.make_sharded_round(
                    mesh, dp_axes, b_local=b_local, rho=kcfg.rho,
                    bounds=kcfg.bounds, capacity=max(256, b_local // 4),
                    plan=plan)
                args = (torch.zeros((n_local, d)),
                        _abstract_kmeans_state(n_local, d, k))
            cost, out, _ = op_cost.analyze(fn, *args)
            del out, args
        b_glob = N if kcfg.shard_centroids else b_local * n_dp
        model_flops = 2.0 * b_glob * d * k / n_chips
        roof = _roof(cost, model_flops)
        if "kernel_analytic" in rec:
            ka = rec["kernel_analytic"]
            kr = ra.roofline_terms(ka["f32_flops"], ka["hbm_bytes"],
                                   tf32_flops=ka["tf32_flops"],
                                   net_bytes=cost.net_wire,
                                   nvlink_bytes=cost.nvlink_wire,
                                   model_flops=model_flops)
            ka["roofline"] = _roof_dict(kr)
        rec.update({
            "ok": True, "t_trace_s": round(time.time() - t0, 2),
            "flops_per_device": cost.flops,
            "flops_by_dtype": cost.flops_by_dtype,
            "hbm_bytes_per_device": cost.bytes,
            "wire_bytes_per_device": cost.wire,
            "net_wire_bytes_per_device": cost.net_wire,
            "collectives": cost.wire_by_kind,
            "collective_counts": cost.counts,
            "model_flops_per_device": model_flops,
            "memory": {"peak_bytes": cost.peak_bytes,
                       "fits_hbm": cost.peak_bytes <= HBM_BYTES,
                       "source": "op_cost (fake tensors)"},
            "roofline": _roof_dict(roof),
        })
    except Exception as e:
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:]})
    _write(rec, out_dir)
    extra = ""
    if rec.get("ok") and "kernel_analytic" in rec:
        ka = rec["kernel_analytic"]
        extra = f" kernel_analytic bound={ka['bound_ms']:.3f}ms"
    print(f"[{'OK ' if rec.get('ok') else 'FAIL'}] {cell}{extra}",
          flush=True)
    return rec


def main(argv=None) -> None:
    from repro_torch.launch.mesh import init_fake_group
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kmeans", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--dump-ops", default=None,
                    help="write the traced ops with their counted costs")
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--skip-existing", action="store_true",
                    help="skip cells whose artifact JSON already has ok=true")
    args = ap.parse_args(argv)
    out = Path(args.out)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    def done(cell: str) -> bool:
        f = out / f"{cell}.json"
        if not (args.skip_existing and f.exists()):
            return False
        try:
            return json.loads(f.read_text()).get("ok", False)
        except (OSError, ValueError):
            return False

    n_fail = 0
    for mp in meshes:
        init_fake_group(512 if mp else 256)
        if args.kmeans:
            for name in configs.KMEANS_WORKLOADS:
                if done(f"{name}__round__{_mesh_tag(mp)}"):
                    continue
                rec = run_kmeans_cell(name, multi_pod=mp, out_dir=out)
                n_fail += 0 if rec.get("ok") else 1
        if args.all:
            for arch in configs.list_archs():
                cfg = configs.get_config(arch)
                for shape in configs.shapes_for(cfg):
                    if done(f"{arch}__{shape.name}__{_mesh_tag(mp)}"):
                        continue
                    rec = run_cell(arch, shape, multi_pod=mp, out_dir=out)
                    n_fail += 0 if rec.get("ok") else 1
        elif args.arch:
            shape = {s.name: s for s in configs.ALL_SHAPES}[args.shape]
            rec = run_cell(args.arch, shape, multi_pod=mp, out_dir=out,
                           dump_ops=args.dump_ops)
            n_fail += 0 if rec.get("ok") else 1
    torch.distributed.destroy_process_group()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

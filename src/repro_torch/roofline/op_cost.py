"""Per-device FLOPs, bytes, wire bytes and peak memory of a traced rank.

Port of `repro/roofline/hlo_cost.py`. JAX compiles a step and parses
the partitioned HLO text: dot FLOPs, fusion operand and output bytes
(XLA's unit of memory traffic), while loops times their trip count, and
collective wire bytes. The port has no HLO to parse: it runs eagerly,
and each op it dispatches is a unit of memory traffic, as an XLA fusion
is in JAX. So the counterpart is a `TorchDispatchMode` (`CostMode`) that
watches one rank run its step, usually on fake tensors over a fake
process group (`repro_torch.launch.dryrun`), and counts:

  * FLOPs of the matmul family, by the formulas of
    ``torch.utils.flop_counter``'s registry (so the same count as
    ``FlopCounterMode``), split by the dtype the product runs in: bf16
    (tensor cores), f32 (CUDA cores: the port keeps TF32 off);
  * bytes: each op's tensor operands plus its outputs, as viewed (a
    slice counts its own elements). Views, metadata ops and ops on the
    ``meta`` device (shapes only) count 0; an
    op that writes into its first operand in place reads it only where
    it is not a pure write (``copy_`` and the indexed writes, whose write
    counts the source's bytes, not the destination buffer's: the
    counterpart of JAX's dynamic-update-slice rule);
  * wire bytes of the c10d collectives the rank issues, by kind, with
    JAX's ring formulas (`repro_torch.roofline.analysis.WIRE_FACTOR`),
    split into the wire within an 8-card node and across nodes by the
    group's global ranks; the moved buffer also counts once as bytes;
  * peak live bytes: each new storage's bytes are added when an op makes
    it and taken away when its last tensor is released, over the bytes
    of the arguments registered up front (JAX's ``memory_analysis()``
    ``argument + temp``).

JAX multiplies a while loop's body by its trip count. The port's loops
run on the host. A loop written with `loop` (the train steps'
microbatches) runs its body once under a mode made with ``fold=True``,
each op of it counted as many times as the loop's trips; every other
loop runs whole, and the dry run traces a step at two and at three periods
and extends the count linearly (`extrapolate`). Both are exact where each
trip dispatches the same ops on the same shapes.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.roofline.analysis import WIRE_FACTOR, spans_nodes

aten = torch.ops.aten

#: ops that make or relabel a tensor without moving its bytes
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.lift_fresh,
         aten._local_scalar_dense, aten.is_nonzero, aten.sym_size,
         aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
         aten.equal}
#: in-place writes of a source into selected elements of their first
#: operand: they move the source (and the index), not the buffer
_INDEXED_WRITES = {aten.index_copy_, aten.index_put_, aten.index_add_,
                   aten.scatter_, aten.scatter_add_, aten.masked_scatter_,
                   aten.index_fill_, aten.copy_}
#: c10d op name -> (kind, where its moved buffer is: "out" or "in")
_C10D = {"allreduce_": ("all-reduce", "in"),
         "allreduce_coalesced_": ("all-reduce", "in"),
         "allgather_": ("all-gather", "out"),
         "_allgather_base_": ("all-gather", "out"),
         "allgather_into_tensor_coalesced_": ("all-gather", "out"),
         "reduce_scatter_": ("reduce-scatter", "in"),
         "_reduce_scatter_base_": ("reduce-scatter", "in"),
         "reduce_scatter_tensor_coalesced_": ("reduce-scatter", "in"),
         "alltoall_base_": ("all-to-all", "out"),
         "alltoall_": ("all-to-all", "out"),
         "broadcast_": ("all-gather", "in")}


_DEVICE = torch.ops.prim.device.default
#: op -> does it have a composite (decomposing) kernel?
_COMPOSITE: Dict[Any, bool] = {}


def _composite(func) -> bool:
    hit = _COMPOSITE.get(func)
    if hit is None:
        hit = _COMPOSITE[func] = func.namespace not in ("c10d", "prim") \
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd")
    return hit


#: the folding modes in force, innermost last (`loop`)
_FOLDING = threading.local()


def loop(n: int):
    """``range(n)`` for the loops whose trips repeat the same ops (the
    train steps' microbatches). Under a `CostMode` made with
    ``fold=True``, one trip runs and each op it dispatches, its backward
    included, counts ``n`` times: the counterpart of JAX's trip-count
    rule. The peak is the one trip's."""
    modes = getattr(_FOLDING, "modes", [])
    if not modes or n <= 1:
        yield from range(n)
        return
    mode = modes[-1]
    mode.scale *= n
    try:
        yield 0
    finally:
        mode.scale /= n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _flop_dtype(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _writes_first(func) -> bool:
    args = func._schema.arguments
    return bool(args) and args[0].alias_info is not None \
        and args[0].alias_info.is_write


@dataclasses.dataclass
class OpCost:
    """Per-device cost, JAX's `OpCost` with the port's splits: FLOPs by
    compute dtype, wire bytes within a node and across nodes, collective
    counts, and the peak live bytes."""
    flops: float = 0.0
    bytes: float = 0.0
    wire: float = 0.0
    wire_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    net_wire: float = 0.0
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0

    def _dicts(self):
        return ("wire_by_kind", "flops_by_dtype", "counts")

    def __iadd__(self, o: "OpCost"):
        self.flops += o.flops
        self.bytes += o.bytes
        self.wire += o.wire
        self.net_wire += o.net_wire
        self.peak_bytes = max(self.peak_bytes, o.peak_bytes)
        for name in self._dicts():
            mine = getattr(self, name)
            for k, v in getattr(o, name).items():
                mine[k] = mine.get(k, 0.0) + v
        return self

    def scaled(self, t: float) -> "OpCost":
        return OpCost(self.flops * t, self.bytes * t, self.wire * t,
                      {k: v * t for k, v in self.wire_by_kind.items()},
                      {k: v * t for k, v in self.flops_by_dtype.items()},
                      self.net_wire * t,
                      {k: v * t for k, v in self.counts.items()},
                      self.peak_bytes)

    @property
    def nvlink_wire(self) -> float:
        return self.wire - self.net_wire


def extrapolate(c1: OpCost, c2: OpCost, n: float, at: int = 1) -> OpCost:
    """The cost at ``n`` repeats of a loop body, from the costs at ``at``
    repeats (``c1``) and at one more (``c2``): ``c1 + (n - at) (c2 -
    c1)``, field by field. Exact for every additive field where each
    repeat dispatches the same ops on the same shapes. The peak is
    extended the same way: a loop's stored state grows with its repeats,
    its working set does not (the first repeat's increment can differ,
    so the dry run extends from two and three)."""
    def lin(a, b):
        return a + (n - at) * (b - a)
    out = OpCost(lin(c1.flops, c2.flops), lin(c1.bytes, c2.bytes),
                 lin(c1.wire, c2.wire), net_wire=lin(c1.net_wire, c2.net_wire),
                 peak_bytes=lin(c1.peak_bytes, c2.peak_bytes))
    for name in out._dicts():
        a, b = getattr(c1, name), getattr(c2, name)
        setattr(out, name, {k: lin(a.get(k, 0.0), b.get(k, 0.0))
                            for k in dict.fromkeys([*a, *b])})
    return out


class CostMode(TorchDispatchMode):
    """Counts the cost of every op dispatched under it (see the module's
    docstring). ``keep_ops``: also keep one line an op (``ops``), for
    `dump_ops`; ``fold``: run the body of each `loop` once and count it
    its trips' times. `register` counts tensors made before the mode (the
    step's arguments) as live."""

    def __enter__(self):
        if self.fold:
            if not hasattr(_FOLDING, "modes"):
                _FOLDING.modes = []
            _FOLDING.modes.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        if self.fold:
            _FOLDING.modes.remove(self)
        return super().__exit__(*exc)

    def __init__(self, keep_ops: bool = False, fold: bool = False):
        super().__init__()
        self.fold = fold
        self.scale = 1.0
        self.cost = OpCost()
        self.live = 0.0
        self.keep_ops = keep_ops
        self.ops: List[Tuple[str, float, float, float]] = []
        self._refs: Dict[int, int] = {}
        self._span: Dict[int, bool] = {}

    # -- live bytes ------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":         # shapes only, no memory
            return
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self.live += st.nbytes()
            self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key, st.nbytes())

    def _release(self, key: int, nbytes: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= nbytes

    def register(self, tree) -> None:
        """Count the tensors of ``tree`` (the step's arguments) live."""
        for t in _tensors(tree):
            self._track(t)

    # -- collectives -----------------------------------------------------
    def _across_nodes(self, pg) -> bool:
        try:
            group = dist.ProcessGroup.unbox(pg)
        except (RuntimeError, AttributeError, TypeError):
            return True
        key = id(group)
        if key not in self._span:
            self._span[key] = spans_nodes(
                dist.get_process_group_ranks(group))
        return self._span[key]

    def _collective(self, name: str, args) -> float:
        kind, where = _C10D[name]
        ins = _tensors(args[1]) if len(args) > 1 else []
        outs = _tensors(args[0])
        if name in ("allreduce_", "allreduce_coalesced_", "broadcast_"):
            ins = outs = _tensors(args[0])
        if name == "alltoall_base_":
            splits = [s for s in args[3] if s] if len(args) > 3 else []
            if len(splits) == 1:
                kind = "collective-permute"
        moved = self.scale * float(sum(_nbytes(t) for t in (
            outs if where == "out" else ins)))
        pg = next((a for a in args if isinstance(a, torch.ScriptObject)
                   and "ProcessGroup" in str(a)), None)
        wire = WIRE_FACTOR[kind] * moved
        c = self.cost
        c.wire += wire
        c.wire_by_kind[kind] = c.wire_by_kind.get(kind, 0.0) + wire
        c.counts[kind] = c.counts.get(kind, 0.0) + self.scale
        if pg is None or self._across_nodes(pg):
            c.net_wire += wire
        c.bytes += moved
        return wire

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE:
            return func(*args, **kwargs)
        if _composite(func):
            # a composite op (matmul, einsum's pieces, to, reshape: they
            # reach the mode whole under inference_mode) counts as the ops
            # it decomposes into, as FlopCounterMode counts it
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        flops = moved = wire = 0.0
        if func.namespace == "c10d":
            name = packet.__name__
            if name in _C10D:
                wire = self._collective(name, args)
        else:
            from torch.utils.flop_counter import flop_registry
            if packet in flop_registry:
                flops = self.scale * float(flop_registry[packet](
                    *args, **kwargs, out_val=out))
                first = _tensors(args)[0]
                key = _flop_dtype(first.dtype)
                c = self.cost
                c.flops += flops
                c.flops_by_dtype[key] = c.flops_by_dtype.get(key, 0.0) + flops
            outs = _tensors(out)
            if (packet not in _FREE and func.namespace != "prim" and outs
                    and outs[0].device.type != "meta"
                    and not _is_view(func)):
                ins = _tensors((args, kwargs))
                if packet in _INDEXED_WRITES:
                    # the source (and the index) read, the source written
                    src = ins[1:]
                    moved = float(sum(_nbytes(t) for t in src)
                                  + (_nbytes(src[-1]) if src else 0))
                elif _writes_first(func):
                    moved = float(sum(_nbytes(t) for t in ins)
                                  + _nbytes(ins[0]))
                else:
                    moved = float(sum(_nbytes(t) for t in ins)
                                  + sum(_nbytes(t) for t in outs))
                moved *= self.scale
                self.cost.bytes += moved
        for t in _tensors(out):
            self._track(t)
        if self.keep_ops:
            self.ops.append((str(func), flops, moved, wire))
        return out


def analyze(fn: Callable, *args, keep_ops: bool = False, fold: bool = False,
            **kwargs) -> Tuple[OpCost, Any, Optional[CostMode]]:
    """``fn(*args, **kwargs)`` run under a `CostMode` (``fold``: each
    `loop` traced once), its arguments counted live from the start: (its
    cost, its result, the mode). The result is returned so that the
    caller decides when it dies."""
    mode = CostMode(keep_ops=keep_ops, fold=fold)
    mode.register((args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    return mode.cost, out, mode


def dump_ops(mode: CostMode, path) -> None:
    """Write the traced ops, one a line with its counted FLOPs, bytes and
    wire bytes (the counterpart of JAX's ``--dump-hlo``)."""
    with open(path, "w") as f:
        f.write("op\tflops\tbytes\twire\n")
        for name, fl, by, wi in mode.ops:
            f.write(f"{name}\t{fl:.0f}\t{by:.0f}\t{wi:.0f}\n")

"""Sharding rules for params, activations, caches and batches, and the
layouts they give on a torch mesh.

Port of `repro/models/sharding.py`. Baseline layout (MaxText-style
TP + FSDP), as in JAX:
  * batch / tokens          -> data axes ("pod", "data")
  * attention heads, FFN hidden, experts, vocab -> "model" (TP / EP)
  * the non-TP dim of every weight additionally shards over "data" (FSDP,
    ZeRO-3 storage; the port all-gathers it per period, in the sharded
    layers: `repro_torch.models.layers.gathered`)
  * per-arch fallback: archs whose head/expert counts don't divide the
    model axis (whisper-tiny: 6 heads) keep those weights TP-replicated,
    recorded by `tp_ok()`.

KV caches: batch -> data axes when divisible; KV heads -> "model" when
divisible, otherwise the SEQUENCE dim -> "model".

The rules read only a mesh's axis names and sizes, as JAX's read
``mesh.axis_names`` and ``mesh.shape``: a `MeshDesc`, a torch
`DeviceMesh` (its ``mesh_dim_names`` and ``shape``) or a plain
``(names, sizes)`` pair such as ``(("data", "model"), (16, 16))`` all
serve (`describe`), so the rules run at any rank count without a process
group. A spec is JAX's ``PartitionSpec`` as a tuple: one entry a tensor
dim, each ``None``, an axis name or a tuple of names. Trees are the
port's nested dicts; a leaf's path is its dot-joined keys, as JAX's
``_path_str`` joins ``DictKey``s.

On a process group, `placements` gives a spec as DTensor placements,
`shard_tree` cuts each rank's block out of whole tensors and `gather_tree`
puts the blocks back together.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

from repro_torch.configs.base import ModelConfig

TP = "model"

Spec = Tuple[Any, ...]


def _spec(*entries) -> Spec:
    """A spec of ``entries``, normalised as ``PartitionSpec`` normalises
    them: a one-axis tuple becomes its name and an empty one None."""
    def norm(e):
        if isinstance(e, tuple):
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(norm(e) for e in entries)


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    """A mesh's axis names and sizes, in mesh order: what the rules read
    (JAX's ``mesh.axis_names`` and ``mesh.shape``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def describe(mesh) -> MeshDesc:
    """``mesh`` as a `MeshDesc`: a `MeshDesc`, a `DeviceMesh` or a
    ``(names, sizes)`` pair."""
    if isinstance(mesh, MeshDesc):
        return mesh
    if hasattr(mesh, "mesh_dim_names"):
        return MeshDesc(tuple(mesh.mesh_dim_names),
                        tuple(int(s) for s in mesh.shape))
    names, sizes = mesh
    names, sizes = tuple(names), tuple(int(s) for s in sizes)
    if len(names) != len(sizes):
        raise ValueError(f"mesh axes {names} and sizes {sizes} differ in "
                         f"length")
    return MeshDesc(names, sizes)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in describe(mesh).axis_names if a != TP)


def axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    shape = describe(mesh).shape
    return int(math.prod(shape[a] for a in axes))


def tp_ok(cfg: ModelConfig, mesh) -> bool:
    """Can attention heads shard over the model axis for this arch?"""
    return cfg.n_heads % describe(mesh).shape[TP] == 0


def kv_tp_ok(cfg: ModelConfig, mesh) -> bool:
    return cfg.n_kv_heads % describe(mesh).shape[TP] == 0


# --------------------------------------------------------------------------
# trees with paths
# --------------------------------------------------------------------------

def _path_str(path) -> str:
    return ".".join(str(k) for k in path)


def tree_map_with_path(fn: Callable, tree, *rest, path=()):
    """``fn(path, leaf, *rest_leaves)`` over a nested dict (and the trees
    of ``rest``, of the same structure), keys in each dict's order."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

def _leaf_rule(path: str, ndim: int, cfg: ModelConfig, mesh,
               fsdp) -> Spec:
    """Spec for one param leaf. ``path`` is dot-joined key names.

    Stacked block params carry a leading period axis (never sharded),
    handled by padding the rule with a leading None when ndim exceeds the
    base rank.
    """
    name = path.split(".")[-1]
    in_attn = ".attn." in path or path.endswith("attn") or ".xattn." in path
    attn_tp = TP if tp_ok(cfg, mesh) else None

    if name == "embed":
        return (TP, None)                        # vocab-sharded rows
    if name == "lm_head":
        return (fsdp, TP)
    if name == "enc_in":
        return (None, fsdp)

    def stacked(*spec):
        return tuple([None] * (ndim - len(spec)) + list(spec))

    if name in ("wq", "wk", "wv"):
        if in_attn:
            return stacked(fsdp, attn_tp)
        return stacked(fsdp, TP)                 # unreachable, safety
    if name == "wo":
        return stacked(attn_tp, fsdp)
    if name in ("bq", "bk", "bv"):
        return stacked(attn_tp)
    if name in ("w_gate", "w_up"):
        if ndim >= 3 and ".moe." in path:        # (L, E, D, F)
            return stacked(TP, fsdp, None)
        return stacked(fsdp, TP)
    if name == "w_down":
        if ndim >= 3 and ".moe." in path:        # (L, E, F, D)
            return stacked(TP, fsdp, None)
        return stacked(TP, fsdp)
    if name == "router":
        return stacked(fsdp, None)
    # mamba
    if name in ("wz", "wx"):
        return stacked(fsdp, TP)                 # d_inner over TP (heads)
    if name == "wdt":
        return stacked(fsdp, TP)                 # heads over TP
    if name in ("wB", "wC"):
        return stacked(fsdp, None)               # small shared groups
    if name == "conv_x":
        return stacked(None, TP)
    if name == "conv_bc":
        return stacked(None, None)
    if name in ("A_log", "D", "dt_bias"):
        return stacked(TP)
    if name == "norm":
        return stacked(TP)                       # (d_inner,) TP-sharded
    if name == "out_proj":
        return stacked(TP, fsdp)
    # norms / anything small: replicated
    return (None,) * ndim


def param_specs(cfg: ModelConfig, mesh, params_shape) -> Any:
    """Spec tree for a params tree (tensors, meta tensors, anything with
    ``shape`` and ``ndim``).

    FSDP dim uses "data" (per-pod ZeRO-3); params stay replicated across
    "pod" so the cross-pod traffic per step is one gradient all-reduce.
    """
    mesh = describe(mesh)
    fsdp = "data" if "data" in mesh.axis_names else None

    def rule(path, leaf):
        spec = _leaf_rule(_path_str(path), leaf.ndim, cfg, mesh, fsdp)
        # divisibility guard: drop axes that don't divide
        fixed = []
        for dim, ax in enumerate(spec):
            if ax is None:
                fixed.append(None)
                continue
            size = axis_size(mesh, ax)
            fixed.append(ax if leaf.shape[dim] % size == 0 else None)
        return _spec(*fixed)

    return tree_map_with_path(rule, params_shape)


# --------------------------------------------------------------------------
# batch / activation / cache rules
# --------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, mesh, batch_shape) -> Any:
    mesh = describe(mesh)
    dp = data_axes(mesh)

    def rule(path, leaf):
        name = _path_str(path).split(".")[-1]
        bdim = leaf.shape[0]
        b_ax = dp if bdim % axis_size(mesh, dp) == 0 else None
        if name in ("tokens", "labels"):
            return _spec(b_ax, None)
        if name in ("frames", "patches"):
            return _spec(b_ax, None, None)
        return _spec(b_ax, *[None] * (leaf.ndim - 1))

    return tree_map_with_path(rule, batch_shape)


def cache_specs(cfg: ModelConfig, mesh, cache_shape) -> Any:
    mesh = describe(mesh)
    dp = data_axes(mesh)
    dp_total = axis_size(mesh, dp)
    kv_on_tp = kv_tp_ok(cfg, mesh)
    tp = mesh.shape[TP]

    def rule(path, leaf):
        name = _path_str(path).split(".")[-1]
        if name == "pos":
            return ()
        if name == "enc_out":                    # (B, ctx, D)
            b_ax = dp if leaf.shape[0] % dp_total == 0 else None
            return _spec(b_ax, None, None)
        if name in ("k", "v"):                   # (L, B, S, KV, Dh)
            b_ax = dp if leaf.shape[1] % dp_total == 0 else None
            if kv_on_tp:
                return _spec(None, b_ax, None, TP, None)
            return _spec(None, b_ax, TP, None, None)   # sequence-sharded
        if name == "ssm":                        # (L, B, nh, hd, N)
            b_ax = dp if leaf.shape[1] % dp_total == 0 else None
            nh_ax = TP if leaf.shape[2] % tp == 0 else None
            return _spec(None, b_ax, nh_ax, None, None)
        if name in ("x", "bc"):                  # conv state (L,B,w,C)
            b_ax = dp if leaf.shape[1] % dp_total == 0 else None
            c_ax = TP if (name == "x" and leaf.shape[3] % tp == 0) else None
            return _spec(None, b_ax, None, c_ax)
        return (None,) * leaf.ndim

    return tree_map_with_path(rule, cache_shape)


def activation_spec(mesh, cfg: ModelConfig) -> Spec:
    """(B, S, D) residual-stream constraint."""
    return _spec(data_axes(mesh), None, None)


# --------------------------------------------------------------------------
# layouts on a torch mesh
# --------------------------------------------------------------------------

def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec shards over, in the spec's order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on each mesh dim that tensor dim ``d``'s entry names,
    ``Replicate()`` on the others.

    An entry of several axes, such as ``("pod", "data")``, shards its
    tensor dim over all of them with the first axis major (JAX's order).
    DTensor splits a tensor dim sharded over several mesh dims in mesh-dim
    order, the outermost first, which is the same order when the entry
    lists its axes in mesh order, as every rule here does; another order
    raises.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = describe(mesh).axis_names
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists its axes out of "
                             f"the mesh's order {names}: DTensor cannot "
                             f"place it")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {names[i]!r} shards two dims of "
                                 f"{spec!r}")
            out[i] = Shard(d)
    return out


def block_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` laid out by
    ``spec`` (each sharded dim divided by its axes' ranks)."""
    out = []
    for d, n in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        m = axis_size(mesh, axes) if axes else 1
        if n % m:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"over {axes}")
        out.append(n // m)
    return tuple(out)


def _block(t, spec: Spec, mesh):
    """This rank's block of the whole tensor ``t`` laid out by ``spec``
    (a dim over several axes split row-major over them)."""
    from repro_torch.core.collectives import linear_index
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = axis_size(mesh, axes) if axes else 1
        if n == 1:
            continue
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not divide "
                             f"over {axes}")
        step = t.shape[d] // n
        t = t.narrow(d, linear_index(mesh, axes) * step, step)
    return t


def shard_tree(tree, specs, mesh):
    """Each whole leaf of ``tree`` cut to this rank's block of it under
    its spec in ``specs`` (the same structure), as a tensor of its own:
    the rank's storage of the leaf."""
    return tree_map_with_path(
        lambda _, t, spec: _block(t, spec, mesh).clone(), tree, specs)


def gather_tree(tree, specs, mesh):
    """The whole tensors of a tree of blocks laid out by ``specs``, on
    every rank: `shard_tree`'s inverse, for checks and tests."""
    from repro_torch.core.collectives import gather_along

    def whole(_, t, spec):
        for d, entry in enumerate(spec):
            if entry is not None and axis_size(mesh, _entry_axes(entry)) > 1:
                t = gather_along(t, mesh, _entry_axes(entry), d)
        return t
    return tree_map_with_path(whole, tree, specs)

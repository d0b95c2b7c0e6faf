"""Nested dicts of tensors as trees, walked in JAX's order.

The port's parameter, gradient and moment trees are nested dicts (the
JAX package's pytrees of the model families). `tree_leaves` lists the
leaves as ``jax.tree.leaves`` does (dict keys sorted), so a sum over
them adds in JAX's order; `tree_map` maps leaf-wise over trees of one
structure and keeps each dict's own key order.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, dict keys sorted (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` leaf-wise over ``tree`` and the trees of ``rest`` (the same
    structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)

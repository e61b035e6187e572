"""Nested dicts, lists and tuples with tensors (or scalars) at the leaves:
the port's stand-in for ``jax.tree_util``.  Dicts are visited in sorted-key
order, the order ``jax.tree_util`` flattens them in, so leaf indices agree
between the packages (the store's manifests number leaves this way)."""
from __future__ import annotations

from typing import Any, Callable, Iterable


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf, in sorted-key order; the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def unflatten(like: Any, values: Iterable) -> Any:
    """The structure of ``like`` with its leaves replaced by ``values``, in order."""
    it = iter(values)
    return tree_map(lambda _: next(it), like)

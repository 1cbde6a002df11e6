"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Leaves are visited in sorted key order at every level, the order in which
``jax.tree_util`` flattens a dict, so sums over leaves and checkpoint key
paths follow the JAX package. A ``QuantizedTensor`` is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping the dict structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_flatten_with_keys(tree, prefix: Tuple[str, ...] = ()
                           ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(key path, leaf)]`` in JAX's order (sorted dict keys)."""
    if not isinstance(tree, Mapping):
        return [(prefix, tree)]
    return [kv for k in sorted(tree)
            for kv in tree_flatten_with_keys(tree[k], prefix + (str(k),))]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_keys(tree)]

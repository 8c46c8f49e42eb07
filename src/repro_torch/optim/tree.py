"""Nested dicts of tensors, the port's parameter and optimizer trees:
the three walks the trainer needs, with keys in sorted order (the order
JAX flattens a dict in, so leaf lists line up with the reference's)."""
from __future__ import annotations

from typing import Any, Callable, Iterable, List

import torch


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the like-shaped ``rest``,
    as a new nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: Iterable[Any]) -> Any:
    """A tree shaped like ``like`` holding ``leaves``, given in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)

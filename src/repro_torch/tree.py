"""Nested-dict parameter trees: the few ``jax.tree`` operations the
training path needs.

A tree is a dict whose values are trees or leaves (tensors).  Traversal
visits keys in sorted order, as ``jax.tree`` flattens a dict, so leaf
lists, paths and any reduction over leaves follow the reference's order.
"""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of its shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves in the reference's flattening order."""
    return [leaf for _, leaf in items(tree)]


def items(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs, keys joined with ``/`` (the reference
    checkpoint's key format)."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(items(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out

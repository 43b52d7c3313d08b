"""Nested parameter trees: dicts, lists and tuples (NamedTuples too) with
tensor leaves, as the port keeps parameters and optimizer state.

Leaves come in the JAX package's ``jax.tree.leaves`` order: dict keys
sorted, sequences in order; ``None`` is an empty subtree.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(tree) -> list | None:
    """The subtrees of a node in leaf order, or None for a leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _iter_leaves(tree) -> Iterator[Any]:
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield tree
        return
    for kid in kids:
        yield from _iter_leaves(kid)


def leaves(tree) -> list:
    return list(_iter_leaves(tree))


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure whose leaves are ``values`` in leaf
    order (an iterable consumed exactly)."""
    it = iter(values)
    out = _build(like, it)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def _build(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        built = {k: _build(like[k], it) for k in sorted(like)}
        return {k: built[k] for k in like}
    if isinstance(like, (list, tuple)):
        kids = [_build(v, it) for v in like]
        if isinstance(like, list):
            return kids
        return type(like)(*kids) if hasattr(like, "_fields") else tuple(kids)
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer values than leaves") from None


def map_tree(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, (fn(x, *ys) for x, *ys in
                            zip(leaves(tree), *others, strict=True)))


__all__ = ["leaves", "map_tree", "unflatten"]

"""Trees of tensors in the reference's leaf order.

The reference keeps params, optimizer moments and train states as JAX
pytrees; the port keeps the same nesting of dicts, lists, tuples and
NamedTuples (`optim.AdamWState`) with tensors at the leaves.  These helpers
walk them in `jax.tree_util.tree_flatten`'s order — dict keys sorted, lists
and tuples in order, NamedTuples in field order, ``None`` an empty subtree —
so a checkpoint's flat leaf index means the same leaf in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None) -> List:
    """The leaves of ``tree`` in the reference's flatten order; a node for
    which ``is_leaf`` is true is a leaf, as in `jax.tree_util`."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x, is_leaf)]
    return [] if tree is None else [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in flatten order).
    Raises ValueError when the counts differ."""
    leaves = list(leaves)
    it = iter(leaves)
    out = _build(like, it)
    if next(it, _END) is not _END:
        raise ValueError(f"{len(leaves)} leaves for a tree of {len(tree_leaves(like))}")
    return out


_END = object()


def _build(like, it: Iterator):
    if isinstance(like, dict):
        return {k: _build(like[k], it) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_build(x, it) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_build(x, it) for x in like)
    if like is None:
        return None
    leaf = next(it, _END)
    if leaf is _END:
        raise ValueError("too few leaves for the tree")
    return leaf


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf of ``tree``, keeping its structure."""
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])

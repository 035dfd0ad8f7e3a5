"""Nested parameter trees: dicts, lists and tuples (named ones too) of
tensors.

The port's parameters are plain nested containers (a CNN's flat dict, a
transformer's dict of dicts and a list of blocks); these two helpers play
the part of ``jax.tree_util`` for them.  Dicts are walked in their own key
order, so two trees built the same way line up leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``, in a tree of that structure."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in ``tree_map``'s order."""
    leaves: List[Any] = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)

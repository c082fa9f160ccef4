"""Nested dicts of tensors in place of JAX pytrees.

Dict keys are visited in sorted order, as ``jax.tree_util`` visits them,
so a flattened parameter dict lists its leaves in the reference's order
(``BottleneckBlock_10`` before ``BottleneckBlock_2``).  Lists and tuples
keep their order; every other value is a leaf.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple


def tree_flatten_with_path(tree, prefix: Tuple[str, ...] = ()
                           ) -> List[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten_with_path(tree[k], prefix + (str(k),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += tree_flatten_with_path(v, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; the treedef is the tree itself, read only
    for its structure by :func:`tree_unflatten`."""
    return [leaf for _, leaf in tree_flatten_with_path(tree)], tree


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _rebuild(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def _rebuild(node, it: Iterator[Any]):
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, it) for v in node)
    return next(it)


def tree_leaf_names(tree) -> List[str]:
    """Slash-joined key paths of the leaves (``Dense_0/kernel``)."""
    return ["/".join(path) for path, _ in tree_flatten_with_path(tree)]

"""Nested-container helpers for the port's parameter trees.

A tree is nested dicts and lists with tensors (or ``None``) at the
leaves: the port's params (``layers`` a list of per-layer dicts), the
optimizer's moments, which have the params' tree, and mask trees, which
hold ``None`` where a leaf is dense.  Dicts are walked in insertion
order and lists in index order, so two trees built the same way list
their leaves in the same order.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree`` in order (a ``None`` leaf included)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaves_as(tree: Any, like: Any) -> List[Any]:
    """The leaves of ``tree`` at the leaf positions of ``like``: a
    ``None`` where ``tree`` is ``None`` at or above a leaf of ``like``
    (a dense mask), so the list lines up with ``leaves(like)``."""
    if isinstance(like, dict):
        return [x for k, v in like.items()
                for x in leaves_as(None if tree is None else tree[k], v)]
    if isinstance(like, list):
        return [x for i, v in enumerate(like)
                for x in leaves_as(None if tree is None else tree[i], v)]
    return [tree]


def unflatten(like: Any, flat: List[Any]) -> Any:
    """A tree with ``like``'s structure whose leaves are ``flat``, in
    order."""
    it: Iterator[Any] = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (a ``None`` in ``rest`` at or above a leaf is passed as
    ``None``)."""
    return unflatten(tree, [fn(*xs) for xs in zip(
        leaves(tree), *(leaves_as(r, tree) for r in rest))])


def stack_names(tree: Any) -> List[Tuple[str, ...]]:
    """Each leaf's path of dict keys with every list position replaced by
    ``*``.  A layer stack of the port's trees (a list of per-layer dicts)
    is one stacked ``(L, ...)`` leaf of the JAX package's, so the leaves
    of one name share it, and a leaf under ``n`` lists has the rank
    ``dim + n`` there."""
    out: List[Tuple[str, ...]] = []

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (k,))
        elif isinstance(node, list):
            for v in node:
                visit(v, path + ("*",))
        else:
            out.append(path)

    visit(tree, ())
    return out


def with_paths(tree: Any, sep: str = "/") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, the path the dict keys and list
    indices joined by ``sep`` (``layers/3/mlp/w_in``)."""
    out: List[Tuple[str, Any]] = []

    def visit(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                visit(v, path + (str(i),))
        else:
            out.append((sep.join(path), node))

    visit(tree, ())
    return out

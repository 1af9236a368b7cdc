"""Nested containers of tensors (the port's parameter and optimizer trees)
walked in ``jax.tree_util``'s order: dict keys sorted, named-tuple fields
and sequence items in order.  ``leaves_with_path`` names each leaf by
``jax.tree_util.keystr`` of its path (``['params']['embed']``,
``['opt'].mu['embed']``, ``[0]``), the keys of the reference's checkpoint
files.  Dicts, lists, tuples and named tuples are containers; anything
else (a tensor, a numpy array, a number) is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += leaves_with_path(getattr(tree, f), f"{prefix}.{f}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += leaves_with_path(x, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [x for _, x in leaves_with_path(tree)]


def tree_map(f: Callable, tree, *rest) -> Any:
    """``f`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(f, getattr(tree, n),
                                     *(getattr(r, n) for r in rest))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return f(tree, *rest)


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped like ``like`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    paths = [p for p, _ in leaves_with_path(like)]
    by_path = dict(zip(paths, it))

    def rebuild(t, prefix):
        if isinstance(t, dict):
            return {k: rebuild(t[k], f"{prefix}[{k!r}]") for k in t}
        if _is_namedtuple(t):
            return type(t)(*(rebuild(getattr(t, n), f"{prefix}.{n}")
                             for n in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(x, f"{prefix}[{i}]")
                           for i, x in enumerate(t))
        return by_path[prefix]
    return rebuild(like, "")


def tree_unzip(tree, n: int) -> tuple:
    """``n`` trees from a tree of dicts whose leaves are ``n``-tuples (what
    ``tree_map`` gives for a function that returns ``n`` values)."""
    if isinstance(tree, dict):
        parts = {k: tree_unzip(v, n) for k, v in tree.items()}
        return tuple({k: v[i] for k, v in parts.items()} for i in range(n))
    return tuple(tree)

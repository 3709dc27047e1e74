"""Nested-dict trees of tensors: the port's parameter, gradient and
optimizer-state layout.

Leaves are visited in sorted key order, the order in which
``jax.tree_util`` flattens a dict, and a leaf's path is its tuple of keys
(``("seg0", "c0", "attn", "wq")``); ``"/".join(path)`` is the key the
reference's checkpoints store it under.
"""

from __future__ import annotations

from typing import Any, Callable


def flatten(tree: dict, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """(path, leaf) for every leaf, in sorted key order."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out += flatten(val, prefix + (key,))
        else:
            out.append((prefix + (key,), val))
    return out


def unflatten(items) -> dict:
    """The tree of (path, leaf) pairs; the inverse of ``flatten``."""
    tree: dict = {}
    for path, leaf in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, which must share its structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}

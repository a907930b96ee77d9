"""Minimal nested-container helpers standing in for ``jax.tree_util``.

Trees are nested dicts, lists and tuples; anything else is a leaf.
Flatten order and path strings follow ``jax.tree_util``: dict keys in
sorted order, ``keystr`` paths like ``"['periods']['s0_global']['k']"``.
Placement sorts leaves by these strings, so matching the reference's
strings and order is what makes physical addresses -- and with them
every fault bit -- agree between the two packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_with_path(tree, is_leaf: Callable[[Any], bool] = None
                      ) -> List[Tuple[Path, Any]]:
    """(path, leaf) pairs in ``jax.tree_util`` flatten order."""
    out: List[Tuple[Path, Any]] = []

    def walk(node, path):
        if node is None:
            return
        kids = None if (is_leaf is not None and is_leaf(node)) \
            else _children(node)
        if kids is None:
            out.append((path, node))
            return
        for k, child in kids:
            walk(child, path + (k,))

    walk(tree, ())
    return out


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of a path: ``['a'][0]['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def leaves(tree, is_leaf=None) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def tree_map(fn: Callable[[Any], Any], tree, is_leaf=None):
    """Apply ``fn`` to every leaf, rebuilding the containers."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def set_path(tree, path: Path, value) -> None:
    """Replace the leaf at ``path`` in place (dict/list containers)."""
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value

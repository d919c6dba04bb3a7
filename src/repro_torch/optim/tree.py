"""Parameter trees of the port: nested dicts and lists of tensors.

What ``jax.tree`` does for the JAX package's optimizers: leaves in the
order ``jax.tree_util`` walks a tree (dict keys sorted, list items in
turn), a tree rebuilt from its leaves, and a map over several trees of
one structure.  ``None`` holds no leaf; a tuple is a leaf (a shape in
``models.model.param_spec``).
"""
from __future__ import annotations

from typing import Any, Callable, List

__all__ = ["leaves", "unflatten", "tree_map", "layer_groups"]


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, dict keys sorted."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def unflatten(like: Any, flat: List[Any]) -> Any:
    """``like``'s structure with ``flat``'s items as its leaves, in the
    order :func:`leaves` walks it."""
    it = iter(flat)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(item) for item in node]
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (the same structure), rebuilt as ``tree``."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def layer_groups(tree: Any, path: tuple = ()):
    """(path, leaf) in the JAX package's stacked layout: a list of dicts
    (the port's per-layer parameters, which the JAX package stacks on a
    leading L axis) gives one group a path, its leaf the list of that
    path's tensor in every layer; other leaves come alone.  Dict keys
    sorted, as :func:`leaves`."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from layer_groups(tree[k], path + (k,))
    elif isinstance(tree, list):
        per_layer = [dict(layer_groups(item)) for item in tree]
        for sub in (per_layer[0] if per_layer else {}):
            group = [layer[sub] for layer in per_layer]
            if any(isinstance(x, list) for x in group):
                raise ValueError(f"a layer stack inside a layer stack at "
                                 f"{'/'.join(path + sub)}")
            yield path + sub, group
    elif tree is not None:
        yield path, tree

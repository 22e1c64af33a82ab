"""Nested-dict trees of tensors, flattened in ``jax.tree.flatten``'s order.

The optimizer and the checkpointer walk trees of leaves (dicts, lists,
tuples and NamedTuples; ``None`` holds no leaf). Dicts are visited by
sorted key, recursively, as JAX visits them, so the i-th leaf here is the
reference's i-th leaf: a checkpoint written by either package restores in
the other, and the global norm sums its leaves in the same order.
"""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return flatten(tree)[0]


def flatten(tree):
    """``(leaves, treedef)``; :func:`unflatten` rebuilds the tree."""
    out: list = []

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            keys = sorted(t)
            return (dict, keys, [walk(t[k]) for k in keys])
        if isinstance(t, (list, tuple)):
            return (type(t), None, [walk(x) for x in t])
        out.append(t)
        return "*"

    return out, walk(tree)


def unflatten(treedef, new_leaves):
    it = iter(new_leaves)

    def build(d):
        if d is None:
            return None
        if d == "*":
            return next(it)
        kind, keys, kids = d
        vals = [build(k) for k in kids]
        if kind is dict:
            return dict(zip(keys, vals))
        if kind in (list, tuple):
            return kind(vals)
        return kind(*vals)       # a NamedTuple

    return build(treedef)


def map_(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    flat, treedef = flatten(tree)
    others = [leaves(r) for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])

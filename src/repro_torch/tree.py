"""Nested-container helpers (the part of ``jax.tree`` the port needs).

Parameters, optimizer states and batches are nested dicts, tuples, lists
and NamedTuples of tensors or arrays; these walk them in a fixed order
(dict keys sorted, as ``jax.tree`` orders them).
"""
from __future__ import annotations


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list:
    """The path of each leaf of ``tree``, in ``tree_leaves`` order, as
    ``jax.tree_util.keystr`` writes it: a dict key as ``['name']`` (its
    ``repr`` in brackets), a tuple or list index as ``[0]``, a NamedTuple
    field as ``.name`` — so an AdamW moment reads
    ``['opt'].mu['phase']['layer_0']``.  The checkpoint store names its
    leaves with these, as the reference's does."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [p for f, node in zip(tree._fields, tree)
                for p in tree_paths(node, f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [p for i, node in enumerate(tree)
                for p in tree_paths(node, f"{prefix}[{i}]")]
    return [prefix]


def tree_unflatten(like, leaves) -> object:
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)

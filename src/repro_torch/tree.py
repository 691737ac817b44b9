"""Minimal nested-dict tree helpers.

Parameters, caches and slot-axis trees in the port are plain nested
dicts whose leaves are tensors (or ints for axis trees) — the reference's
pytrees without a registry. `tree_leaves` walks dicts in insertion
order; `sorted_leaves` / `sorted_unflatten` in `jax.tree.flatten`'s
order (keys sorted, a dataclass's fields in declaration order), where
the order itself is part of a result: a checkpoint's leaf files, or a sum
over every leaf that must round as the reference's does."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over ``tree`` and structurally identical
    ``rest`` trees; dicts are the only inner nodes."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves_with_path(tree, _path: tuple = ()) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(tree_leaves_with_path(v, _path + (k,)))
        return out
    return [(_path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def sorted_leaves(tree) -> list:
    """Leaves in `jax.tree.flatten` order: dict keys sorted, dataclass
    fields in declaration order, None an empty subtree."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in sorted_leaves(getattr(tree, f.name))]
    if tree is None:
        return []
    return [tree]


def sorted_unflatten(like, leaves):
    """``like``'s structure (its key order kept) filled with ``leaves``,
    given in `sorted_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        return None if t is None else next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out

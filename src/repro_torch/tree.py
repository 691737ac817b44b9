"""Minimal nested-dict tree helpers.

Parameters, caches and slot-axis trees in the port are plain nested
dicts whose leaves are tensors (or ints for axis trees) — the reference's
pytrees without a registry."""

from __future__ import annotations

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

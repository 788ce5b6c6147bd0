"""Nested-container helpers (port of the part of ``tianshou_tpu/data/tree.py``
that the port uses): ``jax.tree.map`` over dicts, ``Batch``es and tuples of
tensors."""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to every tensor leaf, keeping the container types
    (``Batch`` and other dicts, tuples, named tuples, lists).  With ``rest``,
    ``fn`` takes the matching leaves of every tree, which share ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v, *(r[k] for r in rest))) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensor leaves of ``tree`` in :func:`tree_map`'s order."""
    leaves: list[torch.Tensor] = []
    tree_map(leaves.append, tree)
    return leaves

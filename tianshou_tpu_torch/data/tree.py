"""Nested-container helpers (port of the part of ``tianshou_tpu/data/tree.py``
that the slice uses): ``jax.tree.map`` over dicts, ``Batch``es and tuples of
tensors."""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

__all__ = ["tree_map"]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf, keeping the container types
    (``Batch`` and other dicts, tuples, named tuples, lists)."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)

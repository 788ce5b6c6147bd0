"""Nested-container helpers (port of ``tianshou_tpu/data/tree.py``):
``jax.tree.map`` over dicts, ``Batch``es and tuples of tensors, and the JAX
package's leaf-wise slicing, selection, allocation and writes.  The JAX
package's writes return a new tree; so does :func:`tree_dynamic_update`
here, which writes into copies."""

from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

__all__ = [
    "tree_map",
    "tree_leaves",
    "tree_slice",
    "tree_where",
    "tree_zeros_like_leading",
    "tree_dynamic_update",
    "tree_leading_shape",
]


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


def tree_slice(tree: Any, index: Any) -> Any:
    """Index every leaf of ``tree`` with ``index``."""
    return tree_map(lambda x: x[index], tree)


def tree_where(cond: torch.Tensor, a: Any, b: Any) -> Any:
    """``a`` where ``cond`` else ``b``, leaf by leaf; ``cond`` has the
    leaves' leading shape and broadcasts over their trailing dimensions.
    An empty tree (``()``) launches nothing."""

    def select(x, y):
        return torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim())), x, y)

    return tree_map(select, a, b)


def tree_zeros_like_leading(example: Any, leading: tuple[int, ...], device: str | torch.device = "cpu") -> Any:
    """Zeros shaped ``leading + leaf.shape``, in each leaf's dtype, for
    every leaf of a one-item ``example``."""
    return tree_map(
        lambda x: torch.zeros(tuple(leading) + tuple(torch.as_tensor(x).shape),
                              dtype=torch.as_tensor(x).dtype, device=device),
        example,
    )


def tree_dynamic_update(tree: Any, value: Any, index: Any) -> Any:
    """A copy of ``tree`` with ``value`` written at ``index`` in every
    leaf; ``tree`` itself is unchanged."""

    def write(t, v):
        out = t.clone()
        out[index] = v
        return out

    return tree_map(write, tree, value)


def tree_leading_shape(tree: Any, ndim: int = 1) -> tuple[int, ...]:
    """The first ``ndim`` dimensions of the first leaf in JAX's leaf order,
    which sorts a dict's keys (``()`` for an empty tree)."""
    while isinstance(tree, (dict, tuple, list)):
        if not tree:
            return ()
        tree = tree[min(tree)] if isinstance(tree, dict) else tree[0]
    return tuple(tree.shape[:ndim])

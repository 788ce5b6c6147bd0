"""Device-resident sum tree for prioritized replay (port of
``tianshou_tpu/ops/segtree.py``).

The tree is one ``[2 * pow2(capacity)]`` float32 tensor in heap layout: the
root at index 1, node ``n``'s children at ``2n`` and ``2n + 1``, the leaves
at ``[cap, 2 * cap)``.  An update writes the leaves, then recomputes each
ancestor from its two children, one level at a time.  Duplicate indices
are therefore safe: on CUDA a duplicated leaf write keeps one of the values
in no fixed order, and every ancestor is then rebuilt from the leaf value
that won, never from a propagated difference.

Sampling is the inverse CDF: :func:`segtree_sample` descends from the root
to a leaf for each ``u`` in ``[0, total)``, a deterministic function of
``u``; the caller draws ``u`` (``torch.rand`` from its generator, scaled by
:func:`segtree_total` on the device).  Each operation is a Python loop of a
few small launches over the ``log2(cap)`` levels, with no host
synchronisation.
"""

from __future__ import annotations

import torch

__all__ = ["segtree_init", "segtree_capacity", "segtree_update", "segtree_total", "segtree_sample"]


def _round_up_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def segtree_init(capacity: int, device: torch.device | str) -> torch.Tensor:
    """Zeroed sum tree for ``capacity`` leaves (padded to a power of two)."""
    return torch.zeros((2 * _round_up_pow2(capacity),), dtype=torch.float32, device=device)


def segtree_capacity(tree: torch.Tensor) -> int:
    return tree.shape[0] // 2


def segtree_update(tree: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Set the leaves ``idx`` to ``values`` and rebuild their ancestors, in
    place; returns ``tree``."""
    cap = segtree_capacity(tree)
    pairs = tree.view(cap, 2)  # row n holds node n's children
    node = idx.to(torch.int64) + cap
    tree[node] = values.to(torch.float32)
    for _ in range(cap.bit_length() - 1):
        node = node >> 1
        tree[node] = pairs[node].sum(dim=1)
    return tree


def segtree_total(tree: torch.Tensor) -> torch.Tensor:
    """The sum of all leaves, a 0-d tensor on the tree's device."""
    return tree[1]


def segtree_sample(tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """For each ``u`` in ``[0, total)`` the leaf index whose prefix-sum
    interval contains it."""
    cap = segtree_capacity(tree)
    node = torch.ones(u.shape, dtype=torch.int64, device=u.device)
    u = u.to(torch.float32)
    for _ in range(cap.bit_length() - 1):
        left = node * 2
        left_sum = tree[left]
        go_right = u >= left_sum
        node = left + go_right
        u = torch.where(go_right, u - left_sum, u)
    return node - cap

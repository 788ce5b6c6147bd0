"""Device-resident sum tree for prioritized replay (port of
``tianshou_tpu/ops/segtree.py``).

The tree is one ``[2 * pow2(capacity)]`` float32 tensor in heap layout: the
root at index 1, node ``n``'s children at ``2n`` and ``2n + 1``, the leaves
at ``[cap, 2 * cap)``.  An update writes the leaves, then recomputes each
ancestor from its two children, one level at a time.  Duplicate indices
are therefore safe: on CUDA a duplicated leaf write keeps one of the values
in no fixed order, and every ancestor is then rebuilt from the leaf value
that won, never from a propagated difference.

Sampling is the inverse CDF: :func:`segtree_draw` takes ``u`` in ``[0, 1)``,
scales it by the root on the device, descends from the root to the leaf
whose prefix-sum interval holds it and returns the leaf as a ring's
``(env, pos)`` with its value.  The caller draws ``u`` (``torch.rand`` from
its generator).  :func:`segtree_sample`, the bare descent of ``u`` in
``[0, total)`` to a leaf index, is the JAX package's counterpart and runs on
CPU tensors only.

On a CUDA tensor :func:`segtree_update` and :func:`segtree_draw` are one
launch each of a hand-written Hopper kernel of ``csrc/segtree.cu`` (built at
first use by :mod:`._build`); on a CPU tensor they run their plain versions
(``*_plain``), a Python loop of a few small launches over the ``log2(cap)``
levels.  There is no fallback from one to the other: a CUDA tensor gets the
kernel or an error.  Both do the same float32 operations in the same order,
so with distinct indices they give bitwise the same tree, leaves and values.
A leaf outside the tree raises ``IndexError`` on the CPU and fails the
kernel's launch on the card.  Each wrapper counts its kernel's launches from
the host, as :func:`~tianshou_tpu_torch.ops.gather.gather_rows_cast` does;
the counter ``segtree.route`` (:mod:`~tianshou_tpu_torch.utils.trace`)
counts every call by route, ``kernel`` or ``plain``, those made while a
CUDA graph captures included, which launch nothing.  Nothing reads a value
back to the host on the card.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.ops import _build
from tianshou_tpu_torch.utils import trace

__all__ = ["segtree_init", "segtree_capacity", "segtree_update", "segtree_total", "segtree_sample", "segtree_draw",
           "segtree_update_plain", "segtree_sample_plain", "segtree_draw_plain"]


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


def segtree_total(tree: torch.Tensor) -> torch.Tensor:
    """The sum of all leaves, a 0-d tensor on the tree's device."""
    return tree[1]


# -- the plain versions: the CPU's route and the kernels' reference -------------
def segtree_update_plain(tree: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Set the leaves ``idx`` to ``values`` and rebuild their ancestors, in
    place, one level a step; returns ``tree``."""
    cap = segtree_capacity(tree)
    pairs = tree.view(cap, 2)  # row n holds node n's children
    node = idx.to(torch.int64) + cap
    tree[node] = values.to(torch.float32)
    for _ in range(cap.bit_length() - 1):
        node = node >> 1
        tree[node] = pairs[node].sum(dim=1)
    return tree


def segtree_sample_plain(tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """For each ``u`` in ``[0, total)`` the leaf index whose prefix-sum
    interval contains it, one level a step."""
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


def segtree_draw_plain(
    tree: torch.Tensor, u: torch.Tensor, slots: int, row_len: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`segtree_draw` as :func:`segtree_sample_plain` of ``u * total``."""
    flat = segtree_sample_plain(tree, u * segtree_total(tree))
    # a draw at the very top of the range may land on a padding leaf
    flat = torch.clamp(flat, max=slots - 1)
    return flat // row_len, flat % row_len, tree[flat + segtree_capacity(tree)]


# -- the wrappers ------------------------------------------------------------------
def _check_tree(tree: torch.Tensor) -> None:
    n = tree.shape[0] if tree.dim() == 1 else 0
    if tree.dtype != torch.float32 or n < 2 or n & (n - 1) or not tree.is_contiguous():
        raise ValueError(
            f"tree must be a contiguous 1-D float32 tensor of a power-of-two length >= 2, got {tree.dtype} "
            f"{tuple(tree.shape)} contiguous={tree.is_contiguous()}"
        )


def _check_indices(t: torch.Tensor, name: str, device: torch.device, batch: int | None = None) -> None:
    if t.dim() != 1 or t.dtype not in (torch.int64, torch.int32) or (batch is not None and t.shape[0] != batch):
        entries = "any" if batch is None else batch
        raise ValueError(f"{name} must be a 1-D int64/int32 tensor of {entries} entries, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device} but the tree on {device}")


def _kernel_route(device: torch.device) -> bool:
    """Whether ``device`` takes the kernel (CUDA) or the plain version (CPU);
    counts the call's route."""
    if device.type == "cpu":
        trace.count("segtree.route", "plain")
        return False
    if device.type != "cuda":
        raise ValueError(f"no segtree kernel for device {device}")
    trace.count("segtree.route", "kernel")
    return True


def _launch_args(device: torch.device) -> tuple[int, int]:
    """The card's index and the raw handle of its current stream, which a
    CUDA graph capture records into."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


def _int64(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int64 and t.is_contiguous() else t.to(torch.int64).contiguous()


def _count(fn) -> None:
    if not torch.cuda.is_current_stream_capturing():  # a capture records the launch; each replay runs it
        fn.launches += 1


def segtree_update(
    tree: torch.Tensor,
    idx: torch.Tensor,
    values: torch.Tensor,
    *,
    rows: torch.Tensor | None = None,
    row_stride: int = 0,
) -> torch.Tensor:
    """Set the leaves ``idx`` to ``values`` and rebuild their ancestors, in
    place; returns ``tree``.

    With ``row_stride`` the leaf of entry ``b`` is ``rows[b] * row_stride +
    idx[b]`` (``rows`` absent: ``b``), a ring's flat slot ``env * capacity +
    pos``.  ``values`` is ``[B]``, or 0-d for one value at every leaf.  On
    CUDA one launch of ``segtree_update_kernel``.  Every leaf must lie in
    ``[0, segtree_capacity(tree))``: the CPU raises ``IndexError``, the
    kernel traps and the next synchronising call raises.
    """
    _check_tree(tree)
    device = tree.device
    _check_indices(idx, "idx", device)
    batch = idx.shape[0]
    if rows is not None:
        _check_indices(rows, "rows", device, batch)
    if not values.is_floating_point() or values.device != device or values.shape not in ((), (batch,)):
        raise ValueError(f"values must be a floating tensor of shape () or ({batch},) on {device}, got "
                         f"{values.dtype} {tuple(values.shape)} on {values.device}")
    if not _kernel_route(device):
        if rows is not None or row_stride:
            base = rows.to(torch.int64) if rows is not None else torch.arange(batch, device=device)
            idx = base * row_stride + idx.to(torch.int64)
        cap = segtree_capacity(tree)
        bad = idx[(idx < 0) | (idx >= cap)]
        if bad.numel():
            raise IndexError(f"{bad.numel()} leaves outside the tree's [0, {cap}), the first {bad[:4].tolist()}")
        return segtree_update_plain(tree, idx, values)
    if batch == 0:
        return tree
    values = values.to(torch.float32).contiguous()
    idx, rows = _int64(idx), None if rows is None else _int64(rows)
    lib = _build.library("segtree")
    code = lib.ts_segtree_update(
        tree.data_ptr(), segtree_capacity(tree), None if rows is None else rows.data_ptr(), idx.data_ptr(),
        row_stride, values.data_ptr(), values.dim(), batch, *_launch_args(device),
    )
    _build.check(lib, code, "segtree_update launch")
    _count(segtree_update)
    return tree


def segtree_sample(tree: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """For each ``u`` in ``[0, total)`` the leaf index whose prefix-sum
    interval contains it (int64, ``u``'s shape): the plain descent, on CPU
    tensors only.  The card descends with :func:`segtree_draw`."""
    _check_tree(tree)
    if not u.is_floating_point() or u.device != tree.device:
        raise ValueError(f"u must be a floating tensor on {tree.device}, got {u.dtype} on {u.device}")
    if tree.device.type != "cpu":
        raise ValueError(f"segtree_sample runs on CPU tensors; on {tree.device} segtree_draw descends")
    trace.count("segtree.route", "plain")
    return segtree_sample_plain(tree, u)


def segtree_draw(
    tree: torch.Tensor, u: torch.Tensor, slots: int, row_len: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each ``u`` (float32, 1-D) in ``[0, 1)`` the leaf whose prefix-sum
    interval holds ``u * total``, at most ``slots - 1`` (a draw at the very
    top may land on a padding leaf): ``(leaf // row_len, leaf % row_len,
    value)``, a ring's ``(env, pos)`` and the leaf's priority.  On CUDA one
    launch of ``segtree_draw_kernel``."""
    _check_tree(tree)
    if u.dim() != 1 or u.dtype != torch.float32 or u.device != tree.device:
        raise ValueError(f"u must be a 1-D float32 tensor on {tree.device}, got {u.dtype} {tuple(u.shape)} "
                         f"on {u.device}")
    cap = segtree_capacity(tree)
    if not 1 <= slots <= cap or row_len < 1:
        raise ValueError(f"need 1 <= slots <= {cap} and row_len >= 1, got slots={slots}, row_len={row_len}")
    if not _kernel_route(tree.device):
        return segtree_draw_plain(tree, u, slots, row_len)
    u = u.contiguous()
    batch = u.shape[0]
    env, pos = (torch.empty(batch, dtype=torch.int64, device=u.device) for _ in range(2))
    p = torch.empty(batch, dtype=torch.float32, device=u.device)
    if batch == 0:
        return env, pos, p
    lib = _build.library("segtree")
    code = lib.ts_segtree_draw(tree.data_ptr(), cap, u.data_ptr(), batch, slots, row_len, env.data_ptr(),
                               pos.data_ptr(), p.data_ptr(), *_launch_args(tree.device))
    _build.check(lib, code, "segtree_draw launch")
    _count(segtree_draw)
    return env, pos, p


segtree_update.launches = 0
segtree_draw.launches = 0

"""Packed host-to-device transfer of a fixed-schema tree (port of
``TreePacker`` in ``tianshou_tpu/utils/transfer.py``).

A host-env segment is a tree of numpy leaves (observations, rewards, flags).
:meth:`TreePacker.to_device` packs them into one contiguous float32 buffer
and sends that in ONE host-to-device copy; :meth:`TreePacker.unpack` cuts it
on the device into views cast to each leaf's dtype.  Exact for float32,
bool and integers below 2**24; float64 leaves arrive as float32, as under
the JAX package's x64-off canonicalisation.

On CUDA the host buffer is pinned and the copy asynchronous
(``copy_(..., non_blocking=True)``).  The host must not write the next
segment into a buffer that an earlier copy may still be reading: the packer
keeps two pinned buffers, records a CUDA event after each copy, and waits on
that buffer's event before packing into it again.  There is no fallback: a
pinned buffer that cannot be made raises.  Each :meth:`to_device` adds
one to ``TreePacker.copies``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["TreePacker"]


def _leaves(tree: Any, like: Any = None) -> list:
    """The leaves of a tree of dicts and sequences, dict keys in sorted
    order (``jax.tree.leaves``'s order, so that the packed layout is the
    JAX package's).  With ``like``, only the keys that ``like`` has."""
    like = tree if like is None else like
    if isinstance(like, dict):
        return [x for k in sorted(like) for x in _leaves(tree[k], like[k])]
    if isinstance(like, (tuple, list)):
        return [x for v, lk in zip(tree, like) for x in _leaves(v, lk)]
    return [tree]


def _torch_dtype(dtype) -> torch.dtype:
    """The dtype a host leaf of numpy ``dtype`` has on the device: float
    kinds become float32, the rest keep their numpy dtype."""
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return torch.float32
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class TreePacker:
    copies = 0

    def __init__(self, example: Any, device: str | torch.device = "cuda"):
        leaves = _leaves(example)
        self.example = example
        self.shapes = [tuple(np.shape(x)) for x in leaves]
        self.dtypes = [_torch_dtype(np.asarray(x).dtype) for x in leaves]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64).tolist()
        self.total = self.offsets[-1]
        self.device = resolve_device(device)
        self._host: list[torch.Tensor] = []
        self._events: list[torch.cuda.Event | None] = []
        if self.device.type == "cuda":
            self._host = [torch.empty((self.total,), dtype=torch.float32, pin_memory=True) for _ in range(2)]
            self._events = [None, None]
        self._next = 0

    def pack(self, tree: Any, out: np.ndarray | None = None) -> np.ndarray:
        """The leaves of ``tree`` as one flat float32 array (into ``out``);
        ``tree`` may hold more keys than the example, which are left out."""
        if out is None:
            out = np.empty((self.total,), np.float32)
        for leaf, off, size in zip(_leaves(tree, self.example), self.offsets, self.sizes):
            out[off:off + size] = np.asarray(leaf, np.float32).ravel()
        return out

    def to_device(self, tree: Any, out: torch.Tensor | None = None) -> torch.Tensor:
        """Pack ``tree`` and send it to :attr:`device` in one copy, into
        ``out`` (a flat float32 tensor there, e.g. a CUDA graph's static
        input) where given."""
        TreePacker.copies += 1
        if self.device.type != "cuda":
            flat = torch.from_numpy(self.pack(tree))
            return flat.to(self.device) if out is None else out.copy_(flat)
        i = self._next
        self._next = 1 - i
        if self._events[i] is not None:
            self._events[i].synchronize()  # the copy that last read this buffer is done
        self.pack(tree, out=self._host[i].numpy())
        flat = torch.empty((self.total,), dtype=torch.float32, device=self.device) if out is None else out
        flat.copy_(self._host[i], non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[i] = event
        return flat

    def unpack(self, flat: torch.Tensor) -> Any:
        """``flat`` cut into the example's leaves: views of it, cast where
        the leaf is not float32."""
        views = iter([flat[off:off + size].view(shape).to(dtype)
                      for off, size, shape, dtype in zip(self.offsets, self.sizes, self.shapes, self.dtypes)])

        def rebuild(tree):
            if isinstance(tree, dict):
                built = {k: rebuild(tree[k]) for k in sorted(tree)}
                return type(tree)((k, built[k]) for k in tree)
            if isinstance(tree, (tuple, list)):
                return type(tree)(rebuild(v) for v in tree)
            return next(views)

        return rebuild(self.example)

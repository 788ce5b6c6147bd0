"""Batch: a nested dict of tensors with attribute access (port of
``tianshou_tpu/data/batch.py``).

``Batch`` is a ``dict`` subclass: ``keys``/``values``/``items``/``get``,
``in`` and iteration are the dict's own, and the port's tree helpers
(``data/tree.py``) map over it as over any dict.  On top of that it has
the JAX package's surface:

- value parsing: a dict becomes a ``Batch``; tensors and numpy arrays are
  kept as they are; Python scalars and (non-ragged) sequences become
  tensors through numpy, so they take numpy's dtypes, as the JAX package's
  numpy leaves do; anything else raises ``TypeError``;
- ``batch.obs`` reads ``batch["obs"]``, attribute assignment and ``del``
  write and delete keys;
- indexing with anything but a key distributes over the leaves
  (``batch[1:3]``, ``batch[mask]``, ``batch[idx]``); assignment at such an
  index writes a ``Batch`` of the same keys into every leaf, in place
  (the JAX package rebinds its immutable arrays);
- ``len`` is the least leading dimension over the leaves (``TypeError``
  on a scalar leaf or an empty batch), ``shape`` the leading dimensions
  all leaves share; ``bool`` stays the dict's (whether it has keys);
- ``to_numpy``, ``to_torch(device)`` (``to_jax``'s counterpart), ``cat``
  and ``stack`` (keys that only some batches carry are zero-filled, at any
  depth), ``split`` into minibatches, ``repr`` and a NaN-aware ``==``.
"""

from __future__ import annotations

from collections.abc import Iterable, Mapping, Sequence
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["Batch"]

_ARRAYS = (torch.Tensor, np.ndarray, np.generic)


def _parse_value(value: Any) -> Any:
    """A value normalised to a ``Batch`` or an array leaf."""
    if isinstance(value, Batch):
        return value
    if isinstance(value, Mapping):
        return Batch(value)
    if isinstance(value, _ARRAYS):
        return value
    if isinstance(value, (bool, int, float, complex)):
        return torch.from_numpy(np.asarray(value))
    if isinstance(value, (list, tuple)):
        try:
            arr = np.asarray(value)
        except (ValueError, TypeError, RuntimeError) as e:
            raise TypeError(f"Cannot store ragged sequence in Batch: {value!r}") from e
        if arr.dtype == object or arr.dtype.kind in "USV":
            raise TypeError(f"Cannot store ragged/object sequence in Batch: {value!r}")
        return torch.from_numpy(arr)
    raise TypeError(f"Unsupported value type for Batch: {type(value)}")


def _shape(x: Any) -> tuple[int, ...]:
    return tuple(x.shape)


def _numpy(x: Any) -> np.ndarray:
    """A leaf as a numpy array (a bfloat16 tensor as float32)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _index(leaf: Any, index: Any) -> Any:
    """``index`` for ``leaf``: a tensor index reads a numpy leaf as a numpy
    array (numpy would take a one-element tensor for a scalar)."""
    if isinstance(index, torch.Tensor) and not isinstance(leaf, torch.Tensor):
        return index.cpu().numpy()
    return index


def _zeros_like_rows(proto: Any, n: int) -> Any:
    """Zeros of ``n`` rows shaped like ``proto``'s trailing dimensions, of its
    kind, dtype and device."""
    if isinstance(proto, torch.Tensor):
        return torch.zeros((n,) + tuple(proto.shape[1:]), dtype=proto.dtype, device=proto.device)
    proto = np.asarray(proto)
    return np.zeros((n,) + proto.shape[1:], proto.dtype)


def _join(np_fn, torch_fn, xs: Sequence[Any], axis: int) -> Any:
    """``np_fn`` over numpy leaves, else ``torch_fn`` over them all as tensors
    on the first tensor's device."""
    if all(isinstance(x, (np.ndarray, np.generic)) for x in xs):
        return np_fn(xs, axis=axis)
    dev = next(x.device for x in xs if isinstance(x, torch.Tensor))
    return torch_fn([torch.as_tensor(x, device=dev) for x in xs], dim=axis)


class Batch(dict):
    """Recursive dict of tensors; indexing and slicing distribute over the
    leaves (see the module docstring)."""

    def __init__(self, data: Mapping | Iterable | None = None, /, **kwargs: Any):
        super().__init__()
        items = () if data is None else (data.items() if isinstance(data, Mapping) else data)
        for k, v in items:
            dict.__setitem__(self, k, _parse_value(v))
        for k, v in kwargs.items():
            dict.__setitem__(self, k, _parse_value(v))

    @classmethod
    def from_items(cls, items: Iterable[tuple[str, Any]]) -> Batch:
        """A ``Batch`` of ``items`` taken as they are, unparsed (the tree
        helpers rebuild a batch so)."""
        out = cls()
        for k, v in items:
            dict.__setitem__(out, k, v)
        return out

    # -- attribute access --------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return dict.__getitem__(self, name)
        except KeyError:
            raise AttributeError(f"Batch has no key {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        dict.__setitem__(self, name, _parse_value(value))

    def __delattr__(self, name: str) -> None:
        try:
            dict.__delitem__(self, name)
        except KeyError:
            raise AttributeError(name) from None

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, index: Any) -> Any:
        if isinstance(index, str):
            return dict.__getitem__(self, index)
        return Batch.from_items((k, v[index] if isinstance(v, Batch) else v[_index(v, index)])
                                for k, v in self.items())

    def __setitem__(self, index: Any, value: Any) -> None:
        if isinstance(index, str):
            dict.__setitem__(self, index, _parse_value(value))
            return
        value = _parse_value(value)
        if not isinstance(value, Batch):
            raise TypeError("Batch slice assignment requires a Batch value")
        for k, leaf in self.items():
            sub = dict.__getitem__(value, k)
            if isinstance(leaf, Batch):
                leaf[index] = sub
            elif isinstance(leaf, np.ndarray):
                leaf[_index(leaf, index)] = _numpy(sub)
            else:  # a tensor: written in place
                leaf[index] = torch.as_tensor(sub, dtype=leaf.dtype, device=leaf.device)

    # -- shape / length ----------------------------------------------------
    def __len__(self) -> int:
        lens = []
        for v in self.values():
            if isinstance(v, Batch):
                if v.is_empty():
                    continue
                lens.append(len(v))
            elif len(getattr(v, "shape", ())) == 0:
                raise TypeError("Batch contains a scalar (or non-array) leaf; it has no len()")
            else:
                lens.append(v.shape[0])
        if not lens:
            raise TypeError("len() of an empty Batch")
        return min(lens)

    def __bool__(self) -> bool:
        return dict.__len__(self) > 0

    def leaves(self) -> list[Any]:
        """Every array leaf, depth first."""
        out = []
        for v in self.values():
            out.extend(v.leaves() if isinstance(v, Batch) else [v])
        return out

    @property
    def shape(self) -> tuple[int, ...]:
        """The leading dimensions every leaf shares (``()`` for none)."""
        shapes = [_shape(leaf) for leaf in self.leaves()]
        if not shapes:
            return ()
        prefix: list[int] = []
        for dims in zip(*shapes):
            if all(d == dims[0] for d in dims):
                prefix.append(dims[0])
            else:
                break
        return tuple(prefix)

    def is_empty(self, recurse: bool = False) -> bool:
        if not dict.__len__(self):
            return True
        if not recurse:
            return False
        return all(isinstance(v, Batch) and v.is_empty(recurse=True) for v in self.values())

    # -- conversion --------------------------------------------------------
    def map(self, fn) -> Batch:
        """``fn`` over every leaf, the structure kept."""
        return Batch.from_items((k, v.map(fn) if isinstance(v, Batch) else fn(v)) for k, v in self.items())

    def to_numpy(self) -> Batch:
        return self.map(_numpy)

    def to_torch(self, device: str | torch.device = "cuda") -> Batch:
        """Every leaf as a tensor on ``device`` (the counterpart of the JAX
        package's ``to_jax``)."""
        dev = resolve_device(device)
        return self.map(lambda x: torch.as_tensor(x, device=dev))

    # -- combination -------------------------------------------------------
    @staticmethod
    def _pad_missing(batches: list[Batch], lens: list[int] | None = None) -> list[Batch]:
        """Zero-fill keys that only some batches carry, recursively, so that
        nested sub-batches with partially overlapping keys align too: a
        missing leaf becomes zeros shaped like a present one, with the
        leading dimension of the batch that lacks it."""
        if lens is None:
            lens = [len(b) for b in batches]
        all_keys: dict[str, Any] = {}
        for b in batches:
            for k, v in b.items():
                all_keys.setdefault(k, v)
        out = [Batch(b) for b in batches]
        for k, proto in all_keys.items():
            if isinstance(proto, Batch):
                # align every batch's sub-batch together (a third batch may
                # carry sub-keys the proto lacks)
                subs = [f[k] if isinstance(f.get(k), Batch) else Batch() for f in out]
                for f, ps in zip(out, Batch._pad_missing(subs, lens)):
                    dict.__setitem__(f, k, ps)
                continue
            for f, n in zip(out, lens):
                if k not in f:
                    dict.__setitem__(f, k, _zeros_like_rows(proto, n))
        return out

    @staticmethod
    def _zip(fn, batches: list[Batch]) -> Batch:
        first = batches[0]
        return Batch.from_items(
            (k, Batch._zip(fn, [b[k] for b in batches]) if isinstance(v, Batch) else fn([b[k] for b in batches]))
            for k, v in first.items())

    @staticmethod
    def cat(batches: Sequence[Batch], axis: int = 0) -> Batch:
        """Concatenate along ``axis``; keys missing from some batches are
        zero-filled.  Numpy leaves stay numpy, else the result is a tensor."""
        batches = [b for b in batches if not b.is_empty(recurse=True)]
        if not batches:
            return Batch()
        return Batch._zip(lambda xs: _join(np.concatenate, torch.cat, xs, axis), Batch._pad_missing(batches))

    @staticmethod
    def stack(batches: Sequence[Batch], axis: int = 0) -> Batch:
        batches = list(batches)
        if not batches:
            return Batch()
        return Batch._zip(lambda xs: _join(np.stack, torch.stack, xs, axis), batches)

    def split(
        self,
        size: int,
        *,
        shuffle: bool = True,
        merge_last: bool = False,
        generator: torch.Generator | None = None,
        seed: int | None = None,
    ) -> list[Batch]:
        """Minibatches of ``size`` rows, a permutation of the rows when
        ``shuffle`` (from ``generator``, else numpy's from ``seed``);
        ``merge_last`` folds a short last minibatch into the one before."""
        n = len(self)
        if shuffle:
            perm = torch.randperm(n, generator=generator, device=generator.device) if generator is not None \
                else torch.from_numpy(np.random.default_rng(seed).permutation(n))
        else:
            perm = torch.arange(n)
        starts = list(range(0, n, size))
        if merge_last and len(starts) > 1 and n - starts[-1] < size:
            starts = starts[:-1]
        out = []
        for i, s in enumerate(starts):
            e = n if (merge_last and i == len(starts) - 1) else min(s + size, n)
            out.append(self[perm[s:e]])
        return out

    # -- misc --------------------------------------------------------------
    def __repr__(self) -> str:
        items = []
        for k in sorted(self):
            v = self[k]
            if isinstance(v, Batch) or not isinstance(v, _ARRAYS):  # a leaf a tree map put there
                items.append(f"{k}: {v!r}")
            else:
                items.append(f"{k}: {type(v).__name__}{_shape(v)} {v.dtype}")
        return f"Batch({', '.join(items)})"

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Batch):
            return NotImplemented
        if sorted(self) != sorted(other):
            return False
        for k, v in self.items():
            w = other[k]
            if isinstance(v, Batch) != isinstance(w, Batch):
                return False
            if isinstance(v, Batch):
                if v != w:
                    return False
            else:
                a, b = _numpy(v), _numpy(w)
                if a.shape != b.shape or not np.allclose(a, b, equal_nan=True):
                    return False
        return True

    def __ne__(self, other: Any) -> bool:
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None  # type: ignore[assignment]

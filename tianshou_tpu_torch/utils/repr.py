"""Readable-representation and pickle-migration mixins (port of
``tianshou_tpu/utils/repr.py``).

- :class:`ToStringMixin` derives ``repr`` from the instance state, with
  field exclusion hooks and protection against cycles.
- Array fields are summarised by shape and dtype (``f32[8,4]``); a
  ``torch.Tensor`` also by its device (``f32[8,4]@cuda:0``), and never by
  its values, a 0-d tensor included: reading a config object must not
  copy from the card.
- :class:`DataclassPPrintMixin` pretty-prints a dataclass as a dict.
- :func:`setstate` / :func:`getstate` migrate pickled objects across
  versions: renamed, added and removed attributes.

Three behaviours follow upstream Tianshou (``tianshou/utils/pickle.py``,
``sensai``'s ``ToStringMixin``) where the JAX package's copy differs:
:func:`getstate` sets transient properties to ``None`` instead of dropping
them, so that a lazy ``if self._cache is None`` re-initialises after
unpickling; :func:`to_string` also guards plain lists, tuples and dicts
against cycles (``<...>``); and :func:`getstate` calls the superclass's
``__getstate__`` once and falls back to the instance ``__dict__`` when that
is not a mapping (a class with ``__slots__``).
"""

from __future__ import annotations

import pprint
import threading
from collections.abc import Mapping, Sequence
from dataclasses import asdict, fields, is_dataclass
from typing import Any

import torch

__all__ = ["ToStringMixin", "DataclassPPrintMixin", "to_string", "setstate", "getstate"]

_MAX_SEQ_ITEMS = 8
_local = threading.local()


def _dtype_name(dtype: Any) -> str:
    kind = str(dtype).removeprefix("torch.")
    return (
        kind.replace("bfloat", "bf").replace("float", "f").replace("uint", "u").replace("int", "i")
        .replace("bool", "b1").replace("complex", "c")
    )


def _array_signature(x: Any) -> str | None:
    """``f32[8,4]``-style signature for numpy arrays, ``f32[8,4]@cpu`` for
    tensors, else None."""
    if isinstance(x, torch.Tensor):
        return f"{_dtype_name(x.dtype)}[{','.join(map(str, x.shape))}]@{x.device}"
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None or dtype is None or not hasattr(x, "__array__"):
        return None
    return f"{_dtype_name(dtype)}[{','.join(map(str, shape))}]"


def _stack() -> set[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = set()
    return stack


def to_string(x: Any, max_items: int = _MAX_SEQ_ITEMS) -> str:
    """Readable, recursion-safe, array-summarising string conversion."""
    sig = _array_signature(x)
    if sig is not None:
        if not isinstance(x, torch.Tensor) and getattr(x, "ndim", 1) == 0:  # numpy scalars print their value
            return repr(x.item() if hasattr(x, "item") else x)
        return sig
    if isinstance(x, ToStringMixin):
        return repr(x)
    if isinstance(x, (Mapping, list, tuple)):
        stack = _stack()
        if id(x) in stack:
            return "<...>"
        stack.add(id(x))
        try:
            if isinstance(x, Mapping):
                items = list(x.items())
                body = ", ".join(f"{k}={to_string(v)}" for k, v in items[:max_items])
                more = len(items) - max_items
                return "{" + body + (f", ... <{more} more>" if more > 0 else "") + "}"
            seq = list(x)
            body = ", ".join(to_string(v) for v in seq[:max_items])
            if len(seq) > max_items:
                body += f", ... <{len(seq) - max_items} more>"
            return ("[" + body + "]") if isinstance(x, list) else "(" + body + ")"
        finally:
            stack.discard(id(x))
    if isinstance(x, type):
        return x.__name__
    if callable(x) and hasattr(x, "__name__"):
        return x.__name__
    return repr(x)


class ToStringMixin:
    """``ClassName(field=value, ...)`` rendering with per-class exclusion
    hooks; a cycle renders as ``ClassName<...>``."""

    def _tostring_excludes(self) -> Sequence[str]:
        """Names of fields to omit (override in subclasses)."""
        return ()

    def _tostring_includes(self) -> Mapping[str, Any]:
        """Extra key/value pairs to render (override in subclasses)."""
        return {}

    def __repr__(self) -> str:
        stack = _stack()
        if id(self) in stack:
            return f"{type(self).__name__}<...>"
        stack.add(id(self))
        try:
            if is_dataclass(self):
                state = {f.name: getattr(self, f.name) for f in fields(self) if f.repr}
            else:
                state = {k: v for k, v in vars(self).items() if not k.startswith("_")}
            for k in self._tostring_excludes():
                state.pop(k, None)
            state.update(self._tostring_includes())
            body = ", ".join(f"{k}={to_string(v)}" for k, v in state.items())
            return f"{type(self).__name__}({body})"
        finally:
            stack.discard(id(self))

    __str__ = __repr__


class DataclassPPrintMixin:
    """Pretty-print a dataclass as a dict."""

    def pprints_asdict(self, exclude_fields: Sequence[str] | None = None, indent: int = 4) -> str:
        d = asdict(self)  # type: ignore[call-overload]
        for f in exclude_fields or ():
            d.pop(f, None)
        header = f"{type(self).__name__}\n" + "-" * 40 + "\n"
        return header + pprint.pformat(d, indent=indent)

    def pprint_asdict(self, exclude_fields: Sequence[str] | None = None, indent: int = 4) -> None:
        print(self.pprints_asdict(exclude_fields=exclude_fields, indent=indent))


def setstate(
    cls: type,
    obj: Any,
    state: dict[str, Any],
    renamed_properties: dict[str, str] | None = None,
    new_optional_properties: Sequence[str] | None = None,
    new_default_properties: dict[str, Any] | None = None,
    removed_properties: Sequence[str] | None = None,
) -> None:
    """Forward-compatible ``__setstate__`` helper: migrate a pickled state
    dict from an older version, then delegate to the superclass's
    ``__setstate__`` if it has one."""
    for old, new in (renamed_properties or {}).items():
        if old in state:
            state[new] = state.pop(old)
    for name in new_optional_properties or ():
        state.setdefault(name, None)
    for name, value in (new_default_properties or {}).items():
        state.setdefault(name, value)
    for name in removed_properties or ():
        state.pop(name, None)
    sup = super(cls, obj)
    if hasattr(sup, "__setstate__"):
        sup.__setstate__(state)
    else:
        obj.__dict__ = state


def getstate(
    cls: type,
    obj: Any,
    transient_properties: Sequence[str] | None = None,
    excluded_properties: Sequence[str] | None = None,
    excluded_default_properties: dict[str, Any] | None = None,
) -> dict[str, Any]:
    """``__getstate__`` helper: transient attributes are pickled as
    ``None``, excluded ones not at all, and attributes equal to a given
    default are omitted (:func:`setstate`'s defaults restore them)."""
    sup = super(cls, obj)
    state = sup.__getstate__() if hasattr(sup, "__getstate__") else None
    state = dict(state) if isinstance(state, Mapping) else dict(obj.__dict__)
    for name in transient_properties or ():
        if name in state:
            state[name] = None
    for name in excluded_properties or ():
        state.pop(name, None)
    for name, default in (excluded_default_properties or {}).items():
        if name in state and state[name] == default:
            del state[name]
    return state

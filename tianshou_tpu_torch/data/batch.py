"""Batch: a nested dict of tensors with attribute access (port of the part of
``tianshou_tpu/data/batch.py`` that the pixel DQN slice uses).

``Batch`` is a ``dict`` subclass, so ``items()``, ``keys()``, ``in`` and
item assignment are the dict's own; ``batch.obs`` reads ``batch["obs"]``.
Slicing, ``cat``/``stack`` and the rest of the JAX package's surface are
for a later slice.
"""

from __future__ import annotations

__all__ = ["Batch"]


class Batch(dict):
    def __getattr__(self, key: str):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value) -> None:
        self[key] = value

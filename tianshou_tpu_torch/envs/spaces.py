"""Minimal space specs (port of ``tianshou_tpu/envs/spaces.py``).

``Discrete`` and ``MultiDiscrete`` actions, ``Box`` observations and
actions.  ``sample`` draws from an explicit ``torch.Generator`` on the
generator's device.  ``dtype`` is the dtype of the port's values in the
space: ``torch.int64`` for the discrete spaces (PyTorch's index type, where
the JAX package has int32) and ``torch.float32`` for ``Box``.
``contains`` checks a value (numpy, tensor or nested lists) on the host,
``Box`` with the JAX package's 1e-6 slack at its bounds.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

__all__ = ["Discrete", "MultiDiscrete", "Box", "Space"]


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int

    @property
    def shape(self) -> tuple[int, ...]:
        return ()

    @property
    def dtype(self) -> torch.dtype:
        return torch.int64

    def contains(self, x) -> bool:
        x = _host(x)
        return bool(np.all((x >= 0) & (x < self.n)))

    def sample(
        self, generator: torch.Generator, batch_shape: tuple[int, ...] = ()
    ) -> torch.Tensor:
        return torch.randint(
            0, self.n, batch_shape, generator=generator, device=generator.device
        )


@dataclasses.dataclass(frozen=True)
class MultiDiscrete:
    nvec: tuple[int, ...]

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.nvec),)

    @property
    def dtype(self) -> torch.dtype:
        return torch.int64

    def contains(self, x) -> bool:
        x = _host(x)
        return bool(np.all((x >= 0) & (x < np.asarray(self.nvec))))

    def sample(
        self, generator: torch.Generator, batch_shape: tuple[int, ...] = ()
    ) -> torch.Tensor:
        nvec = _bound_arr(self.nvec, self.shape, generator.device)
        u = torch.rand(batch_shape + self.shape, generator=generator, device=generator.device)
        return torch.floor(u * nvec).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class Box:
    """Bounds are a scalar or a flat tuple with one entry per element of
    ``shape``."""

    low: tuple[float, ...] | float
    high: tuple[float, ...] | float
    shape: tuple[int, ...]

    @property
    def dtype(self) -> torch.dtype:
        return torch.float32

    def contains(self, x) -> bool:
        x = _host(x)
        return bool(np.all(x >= np.asarray(self.low) - 1e-6) and np.all(x <= np.asarray(self.high) + 1e-6))

    def low_arr(self, device: torch.device | str = "cpu") -> torch.Tensor:
        return _bound_arr(self.low, self.shape, torch.device(device))

    def high_arr(self, device: torch.device | str = "cpu") -> torch.Tensor:
        return _bound_arr(self.high, self.shape, torch.device(device))

    def sample(
        self, generator: torch.Generator, batch_shape: tuple[int, ...] = ()
    ) -> torch.Tensor:
        dev = generator.device
        lo, hi = self.low_arr(dev), self.high_arr(dev)
        u = torch.rand(batch_shape + self.shape, generator=generator, device=dev)
        return lo + u * (hi - lo)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@functools.cache
def _bound_arr(bound, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A stored bound (scalar or flat tuple) or ``nvec`` as a ``shape`` float32 tensor on
    ``device``, made once: copying it to the card at every step would make
    the host wait.  Callers must not write to it."""
    a = torch.as_tensor(bound, dtype=torch.float32, device=device)
    if shape and a.numel() == math.prod(shape):
        return a.reshape(shape)
    return torch.broadcast_to(a, shape)


Space = Discrete | MultiDiscrete | Box

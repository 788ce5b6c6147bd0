"""Minimal space specs (port of ``tianshou_tpu/envs/spaces.py``).

``Discrete`` and ``MultiDiscrete`` actions, ``Box`` observations and
actions.  ``sample`` draws from an explicit ``torch.Generator`` on the
generator's device.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

__all__ = ["Discrete", "MultiDiscrete", "Box", "Space"]


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int

    @property
    def shape(self) -> tuple[int, ...]:
        return ()

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

    def sample(
        self, generator: torch.Generator, batch_shape: tuple[int, ...] = ()
    ) -> torch.Tensor:
        nvec = torch.tensor(self.nvec, dtype=torch.float32, device=generator.device)
        u = torch.rand(batch_shape + self.shape, generator=generator, device=generator.device)
        return torch.floor(u * nvec).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class Box:
    """Bounds are a scalar or a flat tuple with one entry per element of
    ``shape``."""

    low: tuple[float, ...] | float
    high: tuple[float, ...] | float
    shape: tuple[int, ...]

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


@functools.cache
def _bound_arr(bound, shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A stored bound (scalar or flat tuple) as a ``shape`` float32 tensor on
    ``device``, made once: copying it to the card at every step would make
    the host wait.  Callers must not write to it."""
    a = torch.as_tensor(bound, dtype=torch.float32, device=device)
    if shape and a.numel() == math.prod(shape):
        return a.reshape(shape)
    return torch.broadcast_to(a, shape)


Space = Discrete | MultiDiscrete | Box

"""Minimal space specs (port of ``tianshou_tpu/envs/spaces.py``).

Only what the pixel DQN slice uses: ``Discrete`` actions and ``Box``
observations.  ``sample`` draws from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Discrete", "Box", "Space"]


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
class Box:
    low: float
    high: float
    shape: tuple[int, ...]


Space = Discrete | Box

"""Exploration noise processes (port of ``tianshou_tpu/exploration/noise.py``):
``GaussianNoise`` and ``OUNoise`` in the functional form, ``init_state``
then ``sample(state, generator, shape) -> (state, noise)``, with the state
a tensor on the process's device.  ``sample`` takes its standard normal
draw from ``generator``, or ``normal`` in its place (the parity tests feed
the JAX package's draws in).
"""

from __future__ import annotations

import math

import torch

from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["GaussianNoise", "OUNoise"]


def _normal(generator: torch.Generator | None, shape: tuple[int, ...], device: torch.device,
            normal: torch.Tensor | None) -> torch.Tensor:
    if normal is not None:
        return normal
    return torch.randn(shape, generator=generator, device=device)


class GaussianNoise:
    """i.i.d. Gaussian noise ``mu + sigma * N(0, 1)``; its state is unused."""

    def __init__(self, mu: float = 0.0, sigma: float = 1.0, device: str | torch.device = "cuda"):
        self.mu = mu
        self.sigma = sigma
        self.device = resolve_device(device)

    def init_state(self, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.zeros(shape, device=self.device)

    def sample(self, state, generator: torch.Generator | None, shape: tuple[int, ...],
               normal: torch.Tensor | None = None):
        return state, self.mu + self.sigma * _normal(generator, shape, self.device, normal)


class OUNoise:
    """Ornstein-Uhlenbeck process,
    ``x_{t+1} = x_t + theta * (mu - x_t) * dt + sigma * sqrt(dt) * N(0, 1)``,
    shaped like its state."""

    def __init__(
        self,
        mu: float = 0.0,
        sigma: float = 0.3,
        theta: float = 0.15,
        dt: float = 1e-2,
        x0: float = 0.0,
        device: str | torch.device = "cuda",
    ):
        self.mu = mu
        self.sigma = sigma
        self.theta = theta
        self.dt = dt
        self.x0 = x0
        self.device = resolve_device(device)

    def init_state(self, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.full(shape, self.x0, device=self.device)

    def sample(self, state: torch.Tensor, generator: torch.Generator | None, shape=None,
               normal: torch.Tensor | None = None):
        noise = _normal(generator, tuple(state.shape), state.device, normal)
        new = state + self.theta * (self.mu - state) * self.dt + self.sigma * math.sqrt(self.dt) * noise
        return new, new

"""Continuous-control actors and critics (port of ``DeterministicActor``,
``GaussianActor``, ``Critic``, ``CriticEnsemble`` and ``ValueNet`` in
``tianshou_tpu/networks/continuous.py``).

Initialisation follows the JAX package: the MLP bodies are orthogonal (gain
sqrt(2) hidden, 1 output) with zero biases, the Gaussian mean head is
orthogonal with gain 0.01, and the conditioned log-sigma head keeps Flax's
default lecun-normal.  Log-sigma is clipped to ``[-20, 2]``.

:class:`CriticEnsemble` holds its K critics as one
:class:`~tianshou_tpu_torch.networks.common.EnsembleMLP` over the
concatenated observation and action: one batched product per layer.

:class:`Perturbation` and :class:`VAE` are BCQ's behaviour model
(``algos/offline.py``).  The VAE's mean and log-std heads keep Flax's
default lecun-normal; its encoder and decoder are MLPs initialised as
above.  Its two normal draws (the reparameterised latent, the clipped prior
sample of :meth:`VAE.decode`) are taken as arguments, so the parity tests
can feed the JAX package's own.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
from torch import nn

from tianshou_tpu_torch.networks.common import MLP, EnsembleMLP, _flat_dim
from tianshou_tpu_torch.networks.conv import _lecun_normal_

__all__ = [
    "DeterministicActor", "GaussianActor", "Critic", "CriticEnsemble", "ValueNet", "Perturbation", "VAE",
    "LOG_SIG_MIN", "LOG_SIG_MAX",
]

LOG_SIG_MIN = -20.0
LOG_SIG_MAX = 2.0


def _critic_input(obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    return torch.cat([obs.reshape(obs.shape[0], -1), act.reshape(act.shape[0], -1)], dim=-1)


class DeterministicActor(nn.Module):
    """obs -> ``max_action * tanh(MLP(obs))`` (the DDPG/TD3 actor)."""

    def __init__(
        self,
        obs_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        action_dim: int,
        max_action: float = 1.0,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.mlp = MLP(obs_shape, hidden_sizes, action_dim, compute_dtype=compute_dtype)
        self.max_action = max_action

    @property
    def input_dtype(self) -> torch.dtype:
        return self.mlp.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.max_action * torch.tanh(self.mlp(obs))


class GaussianActor(nn.Module):
    """obs -> ``(mu, sigma)`` of a diagonal Gaussian.  ``conditioned_sigma``
    (SAC): sigma is a head on the features; otherwise a learned
    state-independent ``log_sigma`` parameter starting at ``sigma_init``
    (PPO)."""

    def __init__(
        self,
        obs_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        action_dim: int,
        conditioned_sigma: bool = False,
        compute_dtype: torch.dtype | None = None,
        sigma_init: float = 0.0,
    ):
        super().__init__()
        self.mlp = MLP(obs_shape, hidden_sizes, None, compute_dtype=compute_dtype)
        self.mu = nn.Linear(self.mlp.out_features, action_dim)
        self.conditioned_sigma = conditioned_sigma
        self.sigma_init = sigma_init
        if conditioned_sigma:
            self.sigma = nn.Linear(self.mlp.out_features, action_dim)
        else:
            self.log_sigma = nn.Parameter(torch.empty(action_dim))
        self.reset_parameters()

    @property
    def input_dtype(self) -> torch.dtype:
        return self.mlp.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.mlp.reset_parameters(generator)
        nn.init.orthogonal_(self.mu.weight, gain=0.01, generator=generator)
        nn.init.zeros_(self.mu.bias)
        if self.conditioned_sigma:
            _lecun_normal_(self.sigma.weight, generator)
            nn.init.zeros_(self.sigma.bias)
        else:
            nn.init.constant_(self.log_sigma, self.sigma_init)

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.mlp(obs)
        mu = self.mu(feat)
        if self.conditioned_sigma:
            log_sigma = torch.clamp(self.sigma(feat), LOG_SIG_MIN, LOG_SIG_MAX)
        else:
            log_sigma = torch.clamp(self.log_sigma, LOG_SIG_MIN, LOG_SIG_MAX).expand_as(mu)
        return mu, torch.exp(log_sigma)


class Critic(nn.Module):
    """(obs, act) -> scalar Q ``[B]``: an MLP over the flattened obs
    concatenated with the action."""

    def __init__(
        self,
        obs_shape: int | Sequence[int],
        action_dim: int,
        hidden_sizes: Sequence[int],
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.mlp = MLP(_flat_dim(obs_shape) + action_dim, hidden_sizes, 1, compute_dtype=compute_dtype)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        return self.mlp(_critic_input(obs, act)).squeeze(-1)


class CriticEnsemble(EnsembleMLP):
    """K critics evaluated together: ``(obs, act) -> [K, B]``.  K = 2 gives
    the twin critics of TD3 and SAC; REDQ takes 10."""

    def __init__(
        self,
        obs_shape: int | Sequence[int],
        action_dim: int,
        hidden_sizes: Sequence[int],
        num_critics: int = 2,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__(num_critics, _flat_dim(obs_shape) + action_dim, hidden_sizes, 1, compute_dtype)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        return super().forward(_critic_input(obs, act)).squeeze(-1)


class ValueNet(nn.Module):
    """obs -> scalar V ``[B]`` (the on-policy critic): an MLP with one
    output."""

    def __init__(
        self,
        obs_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.mlp = MLP(obs_shape, hidden_sizes, 1, compute_dtype=compute_dtype)

    @property
    def input_dtype(self) -> torch.dtype:
        return self.mlp.input_dtype

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.mlp(obs).squeeze(-1)


class Perturbation(nn.Module):
    """BCQ's perturbation net: ``(obs, act) -> clip(act + phi * max_action *
    tanh(MLP([obs, act])), -max_action, max_action)``, a bounded adjustment
    of a sampled action."""

    def __init__(
        self,
        obs_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        action_dim: int,
        max_action: float = 1.0,
        phi: float = 0.05,
    ):
        super().__init__()
        self.mlp = MLP(_flat_dim(obs_shape) + action_dim, hidden_sizes, action_dim)
        self.max_action = max_action
        self.phi = phi

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.mlp.reset_parameters(generator)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        adj = self.phi * self.max_action * torch.tanh(self.mlp(_critic_input(obs, act)))
        return torch.clamp(act + adj, -self.max_action, self.max_action)


class VAE(nn.Module):
    """BCQ's conditional VAE over actions.  The encoder maps ``[obs, act]``
    to the latent's mean and log-std (clipped to ``[-4, 15]``); the decoder
    maps ``[obs, z]`` to ``max_action * tanh(...)``, its hidden sizes the
    encoder's reversed."""

    LOG_STD_MIN, LOG_STD_MAX = -4.0, 15.0

    def __init__(
        self,
        obs_shape: int | Sequence[int],
        hidden_sizes: Sequence[int],
        action_dim: int,
        latent_dim: int,
        max_action: float = 1.0,
    ):
        super().__init__()
        obs_dim = _flat_dim(obs_shape)
        self.encoder = MLP(obs_dim + action_dim, hidden_sizes, None)
        self.mean_head = nn.Linear(self.encoder.out_features, latent_dim)
        self.log_std_head = nn.Linear(self.encoder.out_features, latent_dim)
        self.decoder = MLP(obs_dim + latent_dim, tuple(reversed(hidden_sizes)), action_dim)
        self.latent_dim = latent_dim
        self.max_action = max_action
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        self.encoder.reset_parameters(generator)
        for head in (self.mean_head, self.log_std_head):
            _lecun_normal_(head.weight, generator)
            nn.init.zeros_(head.bias)
        self.decoder.reset_parameters(generator)

    def forward(
        self, obs: torch.Tensor, act: torch.Tensor, noise: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(reconstruction, mean, log_std)``, the latent drawn as ``mean +
        exp(log_std) * noise`` from ``noise [B, latent_dim]``, a standard
        normal draw."""
        h = self.encoder(_critic_input(obs, act))
        mean = self.mean_head(h)
        log_std = torch.clamp(self.log_std_head(h), self.LOG_STD_MIN, self.LOG_STD_MAX)
        z = mean + torch.exp(log_std) * noise
        return self.decode(obs, z), mean, log_std

    def decode(
        self, obs: torch.Tensor, z: torch.Tensor | None = None, noise: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Actions decoded from ``z``, or without ``z`` from a prior sample,
        ``noise [B, latent_dim]`` (a standard normal draw) clipped to
        ``[-0.5, 0.5]``."""
        if z is None:
            z = torch.clamp(noise, -0.5, 0.5)
        return self.max_action * torch.tanh(self.decoder(_critic_input(obs, z)))

"""Continuous-control actors and critics (port of ``DeterministicActor``,
``GaussianActor``, ``Critic``, ``CriticEnsemble`` and ``ValueNet`` in
``tianshou_tpu/networks/continuous.py``).

Initialisation follows the JAX package: the MLP bodies are orthogonal (gain
sqrt(2) hidden, 1 output) with zero biases, the Gaussian mean head is
orthogonal with gain 0.01, and the conditioned log-sigma head keeps Flax's
default lecun-normal.  Log-sigma is clipped to ``[-20, 2]``.

:class:`CriticEnsemble` holds its K critics as one module: each layer is a
``[K, in, out]`` weight and a ``[K, out]`` bias, and a forward is one
batched product per layer (``baddbmm``), not K separate MLPs.  The first
layer's input is shared by the K critics, so it broadcasts without a copy.
Each critic draws its own init, as ``nn.vmap``'s ``split_rngs`` gives.

``Perturbation`` and ``VAE`` come with their algorithms.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.networks.common import MLP, _flat_dim
from tianshou_tpu_torch.networks.conv import _lecun_normal_

__all__ = ["DeterministicActor", "GaussianActor", "Critic", "CriticEnsemble", "ValueNet", "LOG_SIG_MIN", "LOG_SIG_MAX"]

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


class CriticEnsemble(nn.Module):
    """K critics evaluated together: ``(obs, act) -> [K, B]``.  K = 2 gives
    the twin critics of TD3 and SAC."""

    def __init__(
        self,
        obs_shape: int | Sequence[int],
        action_dim: int,
        hidden_sizes: Sequence[int],
        num_critics: int = 2,
        compute_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.num_critics = num_critics
        self.compute_dtype = compute_dtype
        sizes = [_flat_dim(obs_shape) + action_dim, *hidden_sizes, 1]
        self.weights = nn.ParameterList(
            [nn.Parameter(torch.empty(num_critics, i, o)) for i, o in zip(sizes[:-1], sizes[1:])])
        self.biases = nn.ParameterList([nn.Parameter(torch.empty(num_critics, o)) for o in sizes[1:]])
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        last = len(self.weights) - 1
        with torch.no_grad():
            for i, (w, b) in enumerate(zip(self.weights, self.biases)):
                for k in range(self.num_critics):
                    nn.init.orthogonal_(w[k], gain=1.0 if i == last else math.sqrt(2.0), generator=generator)
                nn.init.zeros_(b)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype or torch.float32
        x = _critic_input(obs, act).to(dt)  # [B, in], shared by the K critics
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            w, b = w.to(dt), b.to(dt)[:, None, :]
            # [B, in] @ [K, in, out] broadcasts to [K, B, out]
            x = torch.matmul(x, w) + b if i == 0 else torch.baddbmm(b, x, w)
            if i != last:
                x = F.relu(x)
        return x.squeeze(-1).to(torch.float32)


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

"""Default network factories that dispatch on the env's spaces (port of
``tianshou_tpu/highlevel/module.py``).

Given only the env metadata they build the network family: Q or logit MLPs
for flat observations and a discrete action space (dueling optional),
Gaussian or deterministic actors and ``(obs, act)`` critics for a
continuous one, and convolutional encoders for pixel observations (rank
>= 2), the MinAtar 3x3 encoder up to 32 pixels and the Nature-DQN stack
above.  The port's networks are shaped at construction, so every factory
passes ``envs.observation_space.shape``; the conv nets keep their bf16
compute, so that a pixel presample goes through ``gather_rows_cast``.
"""

from __future__ import annotations

from collections.abc import Sequence

from torch import nn

from tianshou_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete
from tianshou_tpu_torch.highlevel.env import Environments

__all__ = [
    "is_pixel_space",
    "default_q_network",
    "default_actor",
    "default_value_network",
    "default_continuous_critic",
]


def is_pixel_space(envs: Environments) -> bool:
    """Pixel-like observations: rank >= 2 (``[H, W, C]`` grids or
    ``[stack, H, W, C]`` frame stacks)."""
    shape = getattr(envs.observation_space, "shape", ())
    return shape is not None and len(shape) >= 2


def _conv_encoder_name(envs: Environments) -> str:
    """MinAtar-scale grids (<= 32 px) take the small 3x3 encoder, anything
    larger the Nature-DQN stack."""
    shape = envs.observation_space.shape
    spatial = list(shape[-3:-1]) if len(shape) >= 3 else list(shape)
    return "minatar" if max(spatial, default=0) <= 32 else "nature"


def default_q_network(envs: Environments, hidden_sizes: Sequence[int] = (128, 128), dueling: bool = False) -> nn.Module:
    """Q-network for a discrete action space: an MLP for flat
    observations, a conv encoder for pixels."""
    assert isinstance(envs.action_space, Discrete)
    n, shape = envs.action_space.n, envs.observation_space.shape
    if is_pixel_space(envs):
        from tianshou_tpu_torch.networks.conv import ConvDuelingQNet, ConvQNet

        cls = ConvDuelingQNet if dueling else ConvQNet
        return cls(shape, n, encoder=_conv_encoder_name(envs))
    from tianshou_tpu_torch.networks.common import DuelingQNet, QNet

    return (DuelingQNet if dueling else QNet)(shape, tuple(hidden_sizes), n)


def default_actor(
    envs: Environments,
    hidden_sizes: Sequence[int] = (64, 64),
    conditioned_sigma: bool = False,
    deterministic: bool = False,
) -> nn.Module:
    """Policy network by action space: a discrete one gets a logits net
    (conv for pixels), a ``Box`` a Gaussian (or deterministic) actor."""
    space = envs.action_space
    if isinstance(space, (Discrete, MultiDiscrete)):
        return default_q_network(envs, hidden_sizes)
    assert isinstance(space, Box)
    from tianshou_tpu_torch.networks.continuous import DeterministicActor, GaussianActor

    shape, act_dim = envs.observation_space.shape, space.shape[0]
    if deterministic:
        return DeterministicActor(shape, tuple(hidden_sizes), act_dim)
    return GaussianActor(shape, tuple(hidden_sizes), act_dim, conditioned_sigma=conditioned_sigma)


def default_value_network(envs: Environments, hidden_sizes: Sequence[int] = (64, 64)) -> nn.Module:
    """State-value net V(s) (the on-policy critic); a conv encoder for
    pixels."""
    shape = envs.observation_space.shape
    if is_pixel_space(envs):
        from tianshou_tpu_torch.networks.conv import ConvValueNet

        return ConvValueNet(shape, encoder=_conv_encoder_name(envs))
    from tianshou_tpu_torch.networks.continuous import ValueNet

    return ValueNet(shape, tuple(hidden_sizes))


def default_continuous_critic(
    envs: Environments, hidden_sizes: Sequence[int] = (256, 256), num_critics: int = 2
) -> nn.Module:
    """``(obs, act) -> Q`` ensemble for the DDPG / TD3 / SAC family."""
    from tianshou_tpu_torch.networks.continuous import CriticEnsemble

    return CriticEnsemble(envs.observation_space.shape, envs.action_space.shape[0], tuple(hidden_sizes),
                          num_critics=num_critics)

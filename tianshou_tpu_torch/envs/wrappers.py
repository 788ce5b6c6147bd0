"""Env wrappers (port of ``tianshou_tpu/envs/wrappers.py``): frame stacking,
action-space adapters and truncation semantics.  Each wrapper is itself a
batched :class:`TorchEnv` delegating to the inner env.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.envs.base import StepResult, TorchEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete

__all__ = ["ContinuousToDiscrete", "MultiDiscreteToDiscrete", "TruncatedAsTerminated", "FrameStack"]


def _cached_on(cache: dict, value, device: torch.device):
    """``value`` (a tensor or a tuple of them) on ``device``, copied there
    once: a copy per step would make the host wait for the card."""
    if device not in cache:
        cache[device] = tree_map(lambda x: x.to(device), value)
    return cache[device]


class FrameStack(TorchEnv):
    """Stack the last ``num_stack`` observations along a new axis after the
    batch axis, newest at index -1 (the Atari frame-stack convention).

    Pairs with ``ReplayBuffer(stack_num=k, save_only_last_obs=True,
    ignore_obs_next=True)``: the env emits ``[N, k, ...]`` stacks for
    acting, while the buffer stores each frame once and rebuilds stacks at
    sample time.  On reset the first observation is repeated ``num_stack``
    times.  The state is ``(inner_state, frames)``.
    """

    def __init__(self, env: TorchEnv, num_stack: int):
        if num_stack < 1:
            raise ValueError(f"num_stack must be >= 1, got {num_stack}")
        sp = env.observation_space
        if not isinstance(sp, Box):
            raise TypeError("FrameStack requires Box observations")
        self.env = env
        self.num_stack = num_stack
        self.observation_space = Box(
            low=sp.low * num_stack if isinstance(sp.low, tuple) else sp.low,
            high=sp.high * num_stack if isinstance(sp.high, tuple) else sp.high,
            shape=(num_stack,) + sp.shape,
        )
        self.action_space = env.action_space

    def reset(self, generator, num_envs, device):
        s, obs = self.env.reset(generator, num_envs, device)
        frames = obs[:, None].repeat((1, self.num_stack) + (1,) * (obs.dim() - 1))
        return (s, frames), frames

    def step(self, state, action, generator=None):
        s, frames = state
        s, res = self.env.step(s, action, generator)
        frames = torch.cat([frames[:, 1:], res.obs[:, None]], dim=1)
        return (s, frames), res._replace(obs=frames)


class ContinuousToDiscrete(TorchEnv):
    """Discretize each Box action dim into ``action_per_dim`` mesh points."""

    def __init__(self, env: TorchEnv, action_per_dim: int, force_multidiscrete: bool = False):
        if not isinstance(env.action_space, Box):
            raise TypeError("ContinuousToDiscrete requires a Box action space")
        self.env = env
        self.action_per_dim = action_per_dim
        dims = env.action_space.shape[0]
        self.observation_space = env.observation_space
        self.action_space = (
            Discrete(action_per_dim)
            if dims == 1 and not force_multidiscrete
            else MultiDiscrete((action_per_dim,) * dims)
        )
        low = np.broadcast_to(np.asarray(env.action_space.low), (dims,))
        high = np.broadcast_to(np.asarray(env.action_space.high), (dims,))
        # [dims, action_per_dim], linspace in float64 then rounded, as numpy
        # builds the JAX package's mesh
        self.mesh = torch.from_numpy(
            np.stack([np.linspace(lo, hi, action_per_dim) for lo, hi in zip(low, high)]).astype(np.float32)
        )
        self._on_device: dict[torch.device, torch.Tensor] = {}

    def reset(self, generator, num_envs, device):
        return self.env.reset(generator, num_envs, device)

    def step(self, state, action, generator=None):
        n = action.shape[0]
        idx = action.to(torch.int64).reshape(n, -1)  # [N, dims]
        mesh = _cached_on(self._on_device, self.mesh, action.device)
        cont = mesh[torch.arange(mesh.shape[0], device=action.device), idx]
        if isinstance(self.action_space, Discrete):
            cont = cont.reshape((n,) + self.env.action_space.shape)
        return self.env.step(state, cont, generator)


class MultiDiscreteToDiscrete(TorchEnv):
    """Flatten a MultiDiscrete space into one Discrete via base encoding."""

    def __init__(self, env: TorchEnv):
        if not isinstance(env.action_space, MultiDiscrete):
            raise TypeError("MultiDiscreteToDiscrete requires a MultiDiscrete action space")
        self.env = env
        nvec = np.asarray(env.action_space.nvec)
        self.bases = torch.from_numpy(np.concatenate([np.cumprod(nvec[::-1])[::-1][1:], [1]]).astype(np.int64))
        self.nvec = torch.from_numpy(nvec.astype(np.int64))
        self._on_device: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
        self.observation_space = env.observation_space
        self.action_space = Discrete(math.prod(env.action_space.nvec))

    def reset(self, generator, num_envs, device):
        return self.env.reset(generator, num_envs, device)

    def step(self, state, action, generator=None):
        bases, nvec = _cached_on(self._on_device, (self.bases, self.nvec), action.device)
        multi = torch.remainder(
            torch.div(action.to(torch.int64)[:, None], bases, rounding_mode="floor"), nvec
        )
        return self.env.step(state, multi, generator)


class TruncatedAsTerminated(TorchEnv):
    """Report truncation as termination."""

    def __init__(self, env: TorchEnv):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, generator, num_envs, device):
        return self.env.reset(generator, num_envs, device)

    def step(self, state, action, generator=None):
        state, res = self.env.step(state, action, generator)
        return state, StepResult(
            obs=res.obs,
            reward=res.reward,
            terminated=res.terminated | res.truncated,
            truncated=torch.zeros_like(res.truncated),
        )

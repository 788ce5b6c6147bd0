"""Synthetic Atari-scale pixel environment (port of
``tianshou_tpu/envs/synthetic.py``).

Deterministic 84x84xC uint8 frames with trivial dynamics: a throughput
stand-in for Atari, not a learning benchmark.  For the same ``(t, seed)``
the frames are bitwise equal to the JAX package's: they are computed in
int32, masked with ``& 0xFF`` and cast to uint8.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tianshou_tpu_torch.envs.base import StepResult, TorchEnv
from tianshou_tpu_torch.envs.spaces import Box, Discrete

__all__ = ["SyntheticPixelEnv", "SyntheticPixelState"]


class SyntheticPixelState(NamedTuple):
    t: torch.Tensor  # [N] step counter, int32
    seed: torch.Tensor  # [N] per-episode phase, int32


class SyntheticPixelEnv(TorchEnv):
    """Frames are a rolling interference pattern of three iotas plus the
    step counter and an episode phase.  Episodes truncate at
    ``episode_len`` and never terminate."""

    def __init__(
        self,
        height: int = 84,
        width: int = 84,
        channels: int = 4,
        num_actions: int = 6,
        episode_len: int = 512,
        channel_first: bool = False,
    ):
        self.height = height
        self.width = width
        self.channels = channels
        self.episode_len = episode_len
        self.channel_first = channel_first
        shape = (
            (channels, height, width)
            if channel_first
            else (height, width, channels)
        )
        self.observation_space = Box(low=0.0, high=255.0, shape=shape)
        self.action_space = Discrete(num_actions)

    def frame(self, t: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
        """``[N]`` int32 ``(t, seed)`` -> ``[N, *observation_space.shape]``
        uint8 frames."""
        dev = t.device
        h = torch.arange(self.height, dtype=torch.int32, device=dev)
        w = torch.arange(self.width, dtype=torch.int32, device=dev)
        c = torch.arange(self.channels, dtype=torch.int32, device=dev)
        if self.channel_first:
            base = (c * 101)[:, None, None] + (h * 17)[None, :, None] + (w * 29)[None, None, :]
        else:
            base = (h * 17)[:, None, None] + (w * 29)[None, :, None] + (c * 101)[None, None, :]
        phase = (t.to(torch.int32) * 13 + seed.to(torch.int32) * 7).reshape(-1, 1, 1, 1)
        return ((base[None] + phase) & 0xFF).to(torch.uint8)

    def reset(self, generator, num_envs, device):
        seed = torch.randint(
            0, 1 << 20, (num_envs,), generator=generator, device=device,
            dtype=torch.int32,
        )
        state = SyntheticPixelState(torch.zeros_like(seed), seed)
        return state, self.frame(state.t, state.seed)

    def step(self, state: SyntheticPixelState, action: torch.Tensor, generator=None):
        t = state.t + 1
        obs = self.frame(t, state.seed)
        # reward depends on (t, action) so the Q-head sees non-constant
        # targets; still content-free by design
        reward = (torch.remainder(t + action.to(torch.int32), 7) == 0).to(torch.float32)
        terminated = torch.zeros_like(t, dtype=torch.bool)
        truncated = t >= self.episode_len
        return SyntheticPixelState(t, state.seed), StepResult(obs, reward, terminated, truncated)

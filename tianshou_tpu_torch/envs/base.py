"""Batched on-device environment API (port of ``tianshou_tpu/envs/base.py``).

The JAX package steps one pure env instance under ``vmap``; here an env is
written for a whole batch at once: every state leaf and observation carries
a leading ``[num_envs]`` dimension.

Contract:
- ``reset(generator, num_envs, device) -> (state, obs)``;
- ``step(state, action, generator=None) -> (state, StepResult)`` with
  ``[num_envs, ...]`` leaves; truncation (time limits) lives in the env
  state.  An env that draws while stepping (MinAtar's sticky actions) draws
  from ``generator``, the collector's stream; the JAX package keeps a key in
  the env state instead.  Observations and states may be nested (a dict
  with an action ``mask``, a frame stack beside the inner state).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from tianshou_tpu_torch.data.tree import tree_map
from tianshou_tpu_torch.envs.spaces import Space
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["StepResult", "TorchEnv", "VectorEnv"]


class StepResult(NamedTuple):
    obs: Any
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor

    @property
    def done(self) -> torch.Tensor:
        return self.terminated | self.truncated


class TorchEnv:
    """Base class for batched pure envs (stateless; config only), the
    counterpart of the JAX package's ``JaxEnv``."""

    observation_space: Space
    action_space: Space

    def reset(
        self, generator: torch.Generator, num_envs: int, device: torch.device
    ) -> tuple[Any, torch.Tensor]:
        raise NotImplementedError

    def step(
        self, state: Any, action: torch.Tensor, generator: torch.Generator | None = None
    ) -> tuple[Any, StepResult]:
        raise NotImplementedError


def _select(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where ``done`` else ``b``, broadcasting ``done [N]`` over
    trailing dims."""
    return torch.where(done.reshape(done.shape + (1,) * (a.dim() - 1)), a, b)


class VectorEnv:
    """``num_envs`` lockstep instances of a :class:`TorchEnv` with auto-reset.

    When an instance finishes, ``result.obs`` (stored in the buffer as
    ``obs_next``) stays the terminal observation, while the carried
    observation and state are those of a freshly reset episode.
    """

    def __init__(self, env: TorchEnv, num_envs: int, device: str | torch.device = "cuda"):
        self.env = env
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, generator: torch.Generator) -> tuple[Any, torch.Tensor]:
        return self.env.reset(generator, self.num_envs, self.device)

    def step(
        self, state: Any, action: torch.Tensor, generator: torch.Generator
    ) -> tuple[Any, StepResult, Any]:
        """Step all envs; auto-reset finished ones.

        Returns ``(new_state, result, carry_obs)``: ``result`` holds the true
        transition (terminal obs on done), ``carry_obs`` the observation to
        act on next (reset obs where done).  Every env draws a reset each
        step, as under the JAX package's ``vmap``, so the step never waits on
        the host to learn which envs finished.
        """
        state, result = self.env.step(state, action, generator)
        reset_state, reset_obs = self.env.reset(generator, self.num_envs, self.device)
        done = result.done
        new_state = tree_map(lambda r, s: _select(done, r, s), reset_state, state)
        carry_obs = tree_map(lambda r, o: _select(done, r, o), reset_obs, result.obs)
        return new_state, result, carry_obs

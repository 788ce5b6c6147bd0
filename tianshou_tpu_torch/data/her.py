"""Hindsight experience replay (HER, arXiv 1707.01495) as a transform of the
sampled batch (port of ``tianshou_tpu/data/her.py``).

The ring is never rewritten: :meth:`HERReplayBuffer.sample_her` samples a
one-step batch and, for a share ``future_p = 1 - 1 / future_k`` of its rows,
replaces the desired goal in ``obs`` and ``obs_next`` with the goal
achieved at a future transition of the same episode, and recomputes those
rows' rewards with ``compute_reward_fn``; the other rows keep the stored
reward.  The future transition is ``round(u * remainder)`` steps ahead on
the saturating ``next`` chain, ``u`` uniform and ``remainder`` the real
steps the chain makes within ``horizon - 1`` (so uniform over the rest of
the episode, bounded by the horizon).

Observations are flat vectors; ``achieved_slice`` and ``desired_slice`` are
index ranges into them.  Off-policy algorithms take HER buffers through
``Algorithm._sample_nstep``, with one-step targets.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState

__all__ = ["HERReplayBuffer"]


class HERReplayBuffer(ReplayBuffer):
    def __init__(
        self,
        capacity: int,
        num_envs: int = 1,
        *,
        compute_reward_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
        achieved_slice: tuple[int, int],
        desired_slice: tuple[int, int],
        horizon: int = 16,
        future_k: float = 8.0,
        stack_num: int = 1,
    ):
        """``compute_reward_fn(achieved [B, g], desired [B, g]) -> [B]``."""
        super().__init__(capacity, num_envs, stack_num)
        self.compute_reward_fn = compute_reward_fn
        self.achieved_slice = achieved_slice
        self.desired_slice = desired_slice
        self.horizon = horizon
        self.future_p = 1.0 - 1.0 / future_k

    def _set_desired(self, obs: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        d0, d1 = self.desired_slice
        out = obs.clone()
        out[:, d0:d1] = goal
        return out

    def _achieved(self, obs: torch.Tensor) -> torch.Tensor:
        a0, a1 = self.achieved_slice
        return obs[:, a0:a1]

    def sample_her(
        self,
        state: ReplayBufferState,
        generator: torch.Generator,
        batch_size: int,
        draws: tuple[torch.Tensor, ...] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, Batch]:
        """``(env_idx, pos, weight, batch)``: a one-step batch (``obs, act,
        rew, obs_next, terminated, truncated``) with hindsight goals and
        rewards, unit weights.  ``draws`` is ``(env_idx, pos, u_future,
        u_rewrite)``, in place of the sampled slots and the two ``[B]``
        uniforms drawn from ``generator``."""
        if draws is None:
            env_idx, pos = self.sample_indices(state, generator, batch_size)
            u_future, u_rewrite = (
                torch.rand((batch_size,), generator=generator, device=pos.device) for _ in range(2))
        else:
            env_idx, pos, u_future, u_rewrite = draws
        batch = self.get(state, env_idx, pos)

        chain = [pos]
        cur = pos
        remainder = torch.zeros_like(pos)
        for _ in range(self.horizon - 1):
            nxt = self.next_pos(state, env_idx, cur)
            remainder = remainder + (nxt != cur).to(pos.dtype)
            cur = nxt
            chain.append(cur)
        offset = torch.round(u_future * remainder).to(torch.int64)
        future_pos = torch.stack(chain, dim=1).gather(1, offset[:, None]).squeeze(1)
        new_goal = self._achieved(state.storage["obs_next"][env_idx, future_pos])
        rewrite = u_rewrite < self.future_p

        d0, d1 = self.desired_slice
        goal = torch.where(rewrite[:, None], new_goal, batch["obs"][:, d0:d1])
        rew_hindsight = self.compute_reward_fn(self._achieved(batch["obs_next"]), goal).to(torch.float32)
        out = Batch(
            obs=self._set_desired(batch["obs"], goal),
            act=batch["act"],
            rew=torch.where(rewrite, rew_hindsight, batch["rew"]),
            obs_next=self._set_desired(batch["obs_next"], goal),
            terminated=batch["terminated"],
            truncated=batch["truncated"],
        )
        return env_idx, pos, torch.ones((batch_size,), device=pos.device), out

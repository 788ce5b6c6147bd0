"""DRQN: deep recurrent Q-learning over observation histories (port of
``tianshou_tpu/algos/drqn.py``).

DQN with a ``RecurrentQNet``:

- acting threads the LSTM carry one observation at a time through the
  collector (:meth:`DRQN.act_with_state`); the collector resets an env's
  carry to zeros at the end of its episode.  :meth:`DRQN.act` alone acts
  from a zero carry;
- learning samples its own batch (it overrides ``update``, so the trainer
  calls it once per update) and rebuilds ``stack_num``-long histories of
  ``obs`` and ``obs_next`` from the ring's episode-aware ``prev`` chains
  (``ReplayBuffer.stacked_obs``), each run from a zero carry: the online
  net on ``obs``, the target net (and, for double-Q, the online net) on
  ``obs_next``;
- the target is the one-step ``rew + gamma * (1 - terminated) * q_next``,
  the loss the weighted squared TD error; the Adam step and the periodic
  target copy are DQN's.

Acting one step at a time and learning from zero-carry histories are the
JAX package's semantics.  The sampled ``(env_idx, pos, weight)`` come from
the buffer's ``sample_with_weights``.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.algos.base import TrainState, write_back
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import Discrete

__all__ = ["DRQN"]


class DRQN(DQN):
    def __init__(self, network, action_space: Discrete, *, stack_num: int = 4, **kwargs):
        """``network``: a ``RecurrentQNet``, ``(obs [B, L, D], carry) -> (q,
        carry)``."""
        kwargs.setdefault("n_step", 1)
        super().__init__(network, action_space, **kwargs)
        self.stack_num = stack_num

    def init_policy_state(self, num_envs: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The zero ``(c, h)`` carry of ``num_envs`` envs."""
        return self.network.init_carry(num_envs, self.device)

    @torch.no_grad()
    def act_with_state(self, ts, obs, policy_state, generator, explore, explore_param=0.0):
        q, carry = ts.online(obs, policy_state)
        greedy = q.argmax(dim=-1)
        act = self._epsilon_greedy(greedy, generator, explore_param) if explore else greedy
        return act, Batch(), carry

    def act(self, ts, obs, generator, explore, explore_param=0.0):
        return self.act_with_state(ts, obs, self.init_policy_state(obs.shape[0]), generator, explore,
                                   explore_param)[0]

    @staticmethod
    def _q_from_history(net, stacked: torch.Tensor) -> torch.Tensor:
        return net(stacked, net.init_carry(stacked.shape[0]))[0]

    def update(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        generator: torch.Generator,
        batch_size: int,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        env_idx, pos, weight = buffer.sample_with_weights(bstate, generator, batch_size)
        batch = buffer.get(bstate, env_idx, pos, keys=("act", "rew", "terminated", "truncated"))
        stacked = buffer.stacked_obs(bstate, env_idx, pos, self.stack_num)
        stacked_next = buffer.stacked_obs(bstate, env_idx, pos, self.stack_num, obs_key="obs_next")
        mask = 1.0 - batch["terminated"].to(torch.float32)
        with torch.no_grad():
            q_t = self._q_from_history(ts.target, stacked_next)
            if self.is_double:
                a_star = self._q_from_history(ts.online, stacked_next).argmax(dim=-1, keepdim=True)
                q_next = q_t.gather(-1, a_star).squeeze(-1)
            else:
                q_next = q_t.max(dim=-1).values
            target = batch["rew"] + self.gamma * mask * q_next
        q = self._q_from_history(ts.online, stacked)
        td = q.gather(-1, batch["act"].to(torch.int64)[:, None]).squeeze(-1) - target
        loss = (weight * td.pow(2)).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td.detach().abs())
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach()}

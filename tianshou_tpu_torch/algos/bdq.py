"""Branching dueling Q-network (BDQ; port of ``tianshou_tpu/algos/bdq.py``).

DQN over ``MultiDiscrete`` actions with a ``BranchingQNet`` (``obs -> [B,
branches, actions_per_branch]``):

- acting takes each branch's argmax; exploring replaces a whole action,
  with probability ``explore_param``, by ``MultiDiscrete.sample``;
- the bootstrap is the branch mean of the target's values (double-Q picks
  each branch's action with the online net), discounted by
  ``nstep_return`` (``n_step`` defaults to 1);
- the loss is the weighted squared TD error of every branch, averaged over
  the batch and the branches, and the ``|td|`` averaged over the branches
  is written back to a prioritized buffer;
- the Adam step and the periodic target copy are DQN's.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.algos.base import TrainState, write_back
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.envs.spaces import MultiDiscrete
from tianshou_tpu_torch.ops.returns import nstep_return

__all__ = ["BDQ"]


class BDQ(DQN):
    def __init__(self, network, action_space: MultiDiscrete, **kwargs):
        kwargs.setdefault("n_step", 1)
        super().__init__(network, action_space, **kwargs)
        self.num_branches = len(action_space.nvec)

    @torch.no_grad()
    def act(self, ts, obs, generator, explore, explore_param=0.0):
        greedy = ts.online(obs).argmax(dim=-1)  # [B, branches]
        if not explore:
            return greedy
        rand = self.action_space.sample(generator, (greedy.shape[0],))
        take = torch.rand((greedy.shape[0],), generator=generator, device=greedy.device) < explore_param
        return torch.where(take[:, None], rand, greedy)

    def update_sampled(
        self,
        ts: TrainState,
        buffer: ReplayBuffer,
        bstate: ReplayBufferState,
        sampled: tuple,
        generator: torch.Generator | None = None,
    ) -> tuple[TrainState, ReplayBufferState, dict[str, torch.Tensor]]:
        """``generator`` is unused: the update draws nothing."""
        env_idx, pos, weight, batch, rew_chain, done_chain, term = sampled
        mask = 1.0 - term["terminated"].to(torch.float32)
        with torch.no_grad():
            q_t = ts.target(term["obs_next"])
            if self.is_double:
                a_star = ts.online(term["obs_next"]).argmax(dim=-1, keepdim=True)
                q_next = q_t.gather(-1, a_star).squeeze(-1)
            else:
                q_next = q_t.max(dim=-1).values
            target = nstep_return(rew_chain, done_chain, q_next.mean(dim=-1) * mask, self.gamma)
        q = ts.online(batch["obs"]).gather(-1, batch["act"].to(torch.int64)[..., None]).squeeze(-1)  # [B, nb]
        td = q - target[:, None]
        loss = (weight[:, None] * td.pow(2)).mean()
        bstate = write_back(buffer, bstate, env_idx, pos, td.detach().abs().mean(dim=-1))
        self._finish_update(ts, loss)
        return ts, bstate, {"loss": loss.detach()}

"""Multi-agent policy manager: per-agent dispatch over a shared buffer
(port of ``tianshou_tpu/algos/multiagent.py``).

Acting: every sub-policy acts on the whole batch and the manager takes,
row by row, the action of the agent whose turn it is (``obs["agent_id"]``):
fixed shapes, cheap for a few agents.  Learning: each sub-algorithm updates
through a view of the shared buffer (:class:`_AgentBufferView`) that shows
its own reward column as ``rew`` and weighs other agents' transitions by 0,
the functional form of the reference's per-agent reward slicing.

The train state is a tuple of the sub-algorithms' states; parameters carry
across from the JAX package per sub-algorithm, as for any single one.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState

__all__ = ["MultiAgentPolicyManager"]


class _AgentBufferView(ReplayBuffer):
    """The shared buffer as one agent sees it: its reward column as ``rew``,
    and importance weights 0 on the other agents' turns."""

    def __init__(self, base: ReplayBuffer, agent_idx: int):
        super().__init__(base.capacity, base.num_envs, base.stack_num, base.save_only_last_obs,
                         base.ignore_obs_next, base.sample_avail)
        self._base = base
        self._agent = agent_idx

    def _view(self, state: ReplayBufferState) -> ReplayBufferState:
        storage = Batch(state.storage)
        storage["rew"] = state.storage["rew"][..., self._agent]
        return dataclasses.replace(state, storage=storage)

    def sample_with_weights(self, state, generator, batch_size):
        env_idx, pos, w = self._base.sample_with_weights(state, generator, batch_size)
        agent = state.storage["obs"]["agent_id"][env_idx, pos]
        return env_idx, pos, w * (agent == self._agent).to(torch.float32)

    def get(self, state, env_idx, pos, keys=None, dtypes=None):
        return ReplayBuffer.get(self, self._view(state), env_idx, pos, keys=keys, dtypes=dtypes)

    def nstep_chain(self, state, env_idx, pos, n_step):
        return ReplayBuffer.nstep_chain(self, self._view(state), env_idx, pos, n_step)

    def update_priorities(self, state, env_idx, pos, td_abs):
        return self._base.update_priorities(state, env_idx, pos, td_abs)

    def stacked_obs(self, state, env_idx, pos, stack_num=None, obs_key="obs", dtype=None):
        return self._base.stacked_obs(state, env_idx, pos, stack_num, obs_key, dtype)


class MultiAgentPolicyManager(Algorithm):
    """One sub-algorithm per agent over a turn-based env whose observations
    carry ``agent_id``; its train state is the tuple of theirs."""

    def __init__(self, policies: Sequence[Algorithm], num_agents: int | None = None):
        self.policies = list(policies)
        self.num_agents = num_agents or len(self.policies)
        if len(self.policies) != self.num_agents:
            raise ValueError(f"{len(self.policies)} policies for {self.num_agents} agents")
        self.action_space = self.policies[0].action_space
        self.device = self.policies[0].device

    def init(self, generator: torch.Generator) -> tuple[TrainState, ...]:
        """Each sub-algorithm's state, drawn in agent order from
        ``generator``."""
        return tuple(p.init(generator) for p in self.policies)

    def replace_policy(self, ts: tuple, agent_idx: int, policy: Algorithm, sub_ts: TrainState) -> tuple:
        """Swap one agent's policy and state (an opponent for evaluation or
        league play)."""
        self.policies[agent_idx] = policy
        return ts[:agent_idx] + (sub_ts,) + ts[agent_idx + 1:]

    @torch.no_grad()
    def act(self, ts: tuple, obs: Batch, generator, explore, explore_param=0.0):
        acts = torch.stack([p.act(sub, obs, generator, explore, explore_param)
                            for p, sub in zip(self.policies, ts)])  # [A, N]
        return acts.gather(0, obs["agent_id"].to(torch.int64)[None]).squeeze(0)

    def act_params(self, ts: tuple) -> nn.Module:
        return nn.ModuleDict({str(i): p.act_params(sub) for i, (p, sub) in enumerate(zip(self.policies, ts))})

    def with_act_params(self, ts: tuple, module: nn.Module) -> tuple:
        return tuple(p.with_act_params(sub, module[str(i)]) for i, (p, sub) in enumerate(zip(self.policies, ts)))

    def update_pattern(self, ts: tuple, n_updates: int) -> tuple:
        return tuple(p.update_pattern(sub, n_updates) for p, sub in zip(self.policies, ts))

    def update(self, ts: tuple, buffer: ReplayBuffer, bstate: ReplayBufferState, generator, batch_size: int):
        """One update of each sub-algorithm, in agent order, through its view
        of ``buffer``; metrics are prefixed ``agent{i}/``."""
        new_ts, metrics = [], {}
        for i, (p, sub) in enumerate(zip(self.policies, ts)):
            sub, bstate, m = p.update(sub, _AgentBufferView(buffer, i), bstate, generator, batch_size)
            new_ts.append(sub)
            metrics.update({f"agent{i}/{k}": v for k, v in m.items()})
        return tuple(new_ts), bstate, metrics

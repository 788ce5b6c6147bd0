"""PettingZoo AEC adapter for host multi-agent envs (port of
``tianshou_tpu/envs/pettingzoo_env.py``).

Wraps a PettingZoo AEC env, given by the caller, into the turn-based
convention: observations are dicts ``{obs, mask, agent_id}`` and rewards
per-agent vectors in ``possible_agents`` order, behind a gymnasium-style
``reset``/``step``, so that it runs in :class:`HostVectorEnv` under
:class:`~tianshou_tpu_torch.algos.multiagent.MultiAgentPolicyManager`.
Agents must share their spaces.  Nothing here imports ``pettingzoo``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from tianshou_tpu_torch.envs.spaces import Box, Discrete

__all__ = ["PettingZooEnv"]


class PettingZooEnv:
    def __init__(self, aec_env: Any):
        self.env = aec_env
        self.env.reset()
        self.agents = list(self.env.possible_agents)
        self.agent_idx = {a: i for i, a in enumerate(self.agents)}
        self.num_agents = len(self.agents)
        obs_space = self.env.observation_space(self.agents[0])
        act_space = self.env.action_space(self.agents[0])
        for a in self.agents[1:]:
            if self.env.observation_space(a) != obs_space or self.env.action_space(a) != act_space:
                raise ValueError(f"agent {a!r} has other spaces than {self.agents[0]!r}")
        spaces = getattr(obs_space, "spaces", None)
        inner = spaces["observation"] if spaces is not None and "observation" in spaces else obs_space
        self.observation_space = Box(low=-np.inf, high=np.inf, shape=(int(np.prod(inner.shape)),))
        self.action_space = Discrete(int(act_space.n))

    def _wrap_obs(self) -> dict:
        agent = self.env.agent_selection
        raw = self.env.observe(agent)
        if isinstance(raw, dict) and "observation" in raw:
            obs = np.asarray(raw["observation"], np.float32).reshape(-1)
            mask = np.asarray(raw["action_mask"], np.float32)
        else:
            obs = np.asarray(raw, np.float32).reshape(-1)
            mask = np.ones(self.action_space.n, np.float32)
        return {"obs": obs, "mask": mask, "agent_id": np.int32(self.agent_idx[agent])}

    def reset(self, seed: int | None = None):
        self.env.reset(seed=seed)
        return self._wrap_obs(), {}

    def step(self, action):
        self.env.step(int(action))
        rew = np.asarray([self.env.rewards.get(a, 0.0) for a in self.agents], np.float32)
        agent = self.env.agent_selection
        term = bool(self.env.terminations[agent])
        trunc = bool(self.env.truncations[agent])
        obs = self._wrap_obs()  # the terminal observation, before draining
        if term or trunc:
            # step the remaining agents out so that the AEC episode closes
            while self.env.agents:
                self.env.step(None)
        return obs, rew, term, trunc, {}

    def close(self):
        self.env.close()

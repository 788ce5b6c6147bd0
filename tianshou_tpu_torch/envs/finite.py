"""Finite vectorized environments: a fixed dataset of episodes, each
played exactly once a pass (port of ``tianshou_tpu/envs/finite.py``).

An env is backed by a finite stream of episodes (a validation set, logged
sessions); its ``reset`` returns ``(None, info)`` once the stream is
exhausted.  The vector env then marks it dead and fills its rows with a
default observation until every env is exhausted: one pass over the
dataset plays every episode exactly once across the envs.  Dead-env masking
is host control flow, so this lives on the host path; the card acts on the
batched observations as for :class:`HostVectorEnv`.
"""

from __future__ import annotations

import copy
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.collect.collector import CollectStats
from tianshou_tpu_torch.envs.host import HostStepResult, HostVectorEnv, _stack_obs

__all__ = ["FiniteHostVectorEnv", "collect_dataset_episodes", "FiniteEvalCollector"]


class FiniteHostVectorEnv(HostVectorEnv):
    """:class:`HostVectorEnv` over envs whose ``reset`` returns ``(None,
    info)`` when their episode stream is exhausted.

    - ``alive``: which envs still produce real transitions.
    - Dead envs get the default observation, reward 0 and no termination:
      their rows are not transitions and must stay out of every metric
      (:func:`collect_dataset_episodes`, or the mask of :meth:`step_masked`).
    - Once every env is dead the pass is complete (``exhausted``); the next
      :meth:`reset` starts a new pass.
    """

    def __init__(self, env_fns, **kwargs):
        super().__init__(env_fns, **kwargs)
        self.alive = np.ones(self.num_envs, bool)
        self._default_obs: Any = None

    @property
    def exhausted(self) -> bool:
        return not self.alive.any()

    def _try_reset_env(self, i: int) -> Any:
        """Reset env ``i``; on exhaustion mark it dead and return the
        default observation."""
        obs, _ = self.envs[i].reset()
        if obs is None:
            self.alive[i] = False
            return copy.deepcopy(self._default_obs)
        if self._default_obs is None:
            self._default_obs = copy.deepcopy(obs)
        return obs

    def reset(self, seed: int | None = None) -> Any:
        """Start a pass: every env takes its stream again.  ``seed`` is
        accepted for the host-env surface and unused."""
        self.alive = np.ones(self.num_envs, bool)
        obs = [self._try_reset_env(i) for i in range(self.num_envs)]
        if self._default_obs is None:
            raise RuntimeError("every env exhausted on first reset")
        return _stack_obs([o if o is not None else copy.deepcopy(self._default_obs) for o in obs])

    def step(self, actions: np.ndarray) -> tuple[HostStepResult, Any]:
        res, carry, _ = self.step_masked(actions)
        return res, carry

    def step_masked(self, actions: np.ndarray) -> tuple[HostStepResult, Any, np.ndarray]:
        """Step the live envs: ``(result, carry, was_alive)``, where
        ``was_alive`` marks the rows that hold real transitions."""
        was_alive = self.alive.copy()
        n = self.num_envs
        d = copy.deepcopy(self._default_obs)
        obs_l, carry_l = [d] * n, [d] * n
        rew = np.zeros(n, np.float32)
        term = np.zeros(n, bool)
        trunc = np.zeros(n, bool)
        for i in np.nonzero(was_alive)[0]:
            obs, r, te, tr, _ = self.envs[i].step(actions[i])
            obs_l[i], rew[i], term[i], trunc[i] = obs, r, te, tr
            carry_l[i] = self._try_reset_env(i) if (te or tr) else obs
        return HostStepResult(_stack_obs(obs_l), rew, term, trunc), _stack_obs(carry_l), was_alive


def collect_dataset_episodes(
    algo,
    ts,
    venv: FiniteHostVectorEnv,
    generator: torch.Generator,
    explore: bool = False,
    explore_param: float = 0.0,
    max_steps: int = 1_000_000,
) -> tuple[np.ndarray, np.ndarray]:
    """One full pass of the dataset under the policy (every episode exactly
    once): ``(returns, lens)`` of the real transitions only."""
    obs = venv.reset()
    n = venv.num_envs
    ep_ret = np.zeros(n)
    ep_len = np.zeros(n, np.int64)
    returns: list[float] = []
    lens: list[int] = []
    for _ in range(max_steps):
        if venv.exhausted:
            break
        act = algo.act(ts, torch.as_tensor(obs, device=algo.device), generator, explore, explore_param)
        res, carry, was_alive = venv.step_masked(algo.map_action(act).cpu().numpy())
        ep_ret[was_alive] += res.reward[was_alive]
        ep_len[was_alive] += 1
        for i in np.nonzero((res.terminated | res.truncated) & was_alive)[0]:
            returns.append(float(ep_ret[i]))
            lens.append(int(ep_len[i]))
            ep_ret[i] = 0.0
            ep_len[i] = 0
        obs = carry
    return np.asarray(returns), np.asarray(lens, np.int64)


class FiniteEvalCollector:
    """A test collector over a :class:`FiniteHostVectorEnv`: each
    :meth:`collect_episodes` plays ONE full pass of the dataset and reports
    it.  ``n_episode`` is ignored: the dataset sets the count, and a quota
    would break the exactly-once pass."""

    def __init__(self, algo, venv: FiniteHostVectorEnv):
        self.algo = algo
        self.venv = venv
        self.device = algo.device

    def collect_episodes(
        self,
        ts,
        generator: torch.Generator,
        n_episode: int | None = None,
        explore: bool = False,
        explore_param: float = 0.0,
        **_: Any,
    ) -> CollectStats:
        returns, lens = collect_dataset_episodes(self.algo, ts, self.venv, generator, explore, explore_param)
        return CollectStats(
            n_collected_steps=int(lens.sum()),
            n_collected_episodes=int(len(returns)),
            returns=returns,
            lens=lens,
        )

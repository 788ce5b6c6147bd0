"""Rollout engine (port of ``tianshou_tpu/collect/collector.py``).

The JAX package's ``lax.scan`` over (act -> env step -> buffer write ->
episode bookkeeping) is a Python loop here; everything it touches stays on
the device, and the per-step episode outputs are stacked into ``[T, N]``
tensors that :meth:`Collector.summarize` copies to the host once per
segment.  ``collect_episodes`` runs fixed-size chunks under a host loop
until per-env episode quotas are met; only the first ``quota_i`` episodes of
env ``i`` count.

Observations may be any shape, or dicts (an action ``mask`` beside
``obs``); ``random=True`` acts through :class:`RandomPolicy` (warm-up).
The policy's per-step extras (:meth:`Algorithm.act_with_extras`, e.g. PPO's
``log_prob``) are stored with each transition under ``policy``; with
``record_traj`` the segment's transitions come back stacked ``[T, N, ...]``
as ``outputs["traj"]``, the on-policy trainer's rollout.

A recurrent policy's per-env state (DRQN's LSTM carry) rides in
``CollectState.policy_state``: each step acts through
:meth:`Algorithm.act_with_state`, and at an episode's end the env's state
is reset to :meth:`Algorithm.init_policy_state`'s.  A feedforward policy's
state is ``()``, which costs no launch.  Warm-up acting
(``random=True``) leaves the state as it is.

A multi-agent env's reward is a per-agent vector ``[N, A]``; the episode
return then carries that shape and ``reward_metric`` turns the finished
episodes' per-agent returns ``[K, A]`` into ``[K]`` (default: the first
agent's column), at episode ends and not per step, so that a metric such
as the minimum over agents is exact.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.algos.base import Algorithm, RandomPolicy, TrainState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.data.tree import tree_map, tree_where
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device

__all__ = ["CollectState", "CollectStats", "Collector", "rollout_segment"]


@dataclasses.dataclass
class CollectState:
    """Carried collector state."""

    env_state: Any
    obs: torch.Tensor
    rng: torch.Generator
    ep_ret: torch.Tensor  # [N] (or [N, n_agents]) running episode return
    ep_len: torch.Tensor  # [N] running episode length
    policy_state: Any = ()  # per-env recurrent policy state (LSTM carries)


@dataclasses.dataclass
class CollectStats:
    """Host-side summary of a collection."""

    n_collected_steps: int
    n_collected_episodes: int
    returns: np.ndarray
    lens: np.ndarray

    @property
    def returns_mean(self) -> float:
        return float(self.returns.mean()) if self.returns.size else 0.0

    @property
    def returns_std(self) -> float:
        return float(self.returns.std()) if self.returns.size else 0.0

    @property
    def lens_mean(self) -> float:
        return float(self.lens.mean()) if self.lens.size else 0.0


def _default_reward_metric(ep_rew):
    """Per-agent episode returns ``[K, A]`` (a tensor or an array) as
    ``[K]``: the first agent's column (single-agent returns pass through)."""
    return ep_rew if ep_rew.ndim == 1 else ep_rew[..., 0]


def rollout_segment(
    algo: Algorithm,
    venv: VectorEnv,
    buffer: ReplayBuffer | None,
    num_steps: int,
    explore: bool,
    random: bool = False,
    record_traj: bool = False,
    reward_metric=None,
):
    """Build ``seg(ts, cstate, bstate, explore_param) -> (cstate, bstate,
    outputs)``; ``outputs`` holds ``[T, N]`` tensors ``done``, ``ep_ret`` and
    ``ep_len`` (the latter two non-zero only where an episode ended), and
    with ``record_traj`` the stacked transitions as ``traj``.  With
    ``random``, uniform random actions take the place of ``algo``'s.
    ``reward_metric`` scalarises per-agent episode returns
    (:func:`_default_reward_metric` by default)."""
    actor = RandomPolicy(algo.action_space, algo.device) if random else algo
    reward_metric = reward_metric or _default_reward_metric

    def seg(ts: TrainState, cstate: CollectState, bstate, explore_param: float):
        obs, env_state = cstate.obs, cstate.env_state
        ep_ret, ep_len = cstate.ep_ret, cstate.ep_len
        pstate, init_pstate = cstate.policy_state, algo.init_policy_state(venv.num_envs)
        dones, rets, lens, steps = [], [], [], []
        for _ in range(num_steps):
            act, extras, pstate = actor.act_with_state(ts, obs, pstate, cstate.rng, explore, explore_param)
            env_state, res, carry_obs = venv.step(env_state, algo.map_action(act), cstate.rng)
            done = res.done
            pstate = tree_where(done, init_pstate, pstate)
            if ep_ret.shape != res.reward.shape:
                # a per-agent reward: the return carry takes its shape (it
                # is all zeros here, right after a reset)
                ep_ret = torch.zeros_like(res.reward)
            ep_ret = ep_ret + res.reward
            ep_len = ep_len + 1
            transition = Batch(
                obs=obs, act=act, rew=res.reward, terminated=res.terminated,
                truncated=res.truncated, obs_next=res.obs,
            )
            if extras:
                transition["policy"] = extras
            if buffer is not None:
                bstate = buffer.add(bstate, transition)
            if record_traj:
                steps.append(transition)
            dones.append(done)
            rets.append(torch.where(done, reward_metric(ep_ret), 0.0))
            lens.append(torch.where(done, ep_len, 0))
            ep_ret = torch.where(done.reshape(done.shape + (1,) * (ep_ret.dim() - 1)), 0.0, ep_ret)
            ep_len = torch.where(done, 0, ep_len)
            obs = carry_obs
        outputs = {
            "done": torch.stack(dones),
            "ep_ret": torch.stack(rets),
            "ep_len": torch.stack(lens),
        }
        if record_traj:
            outputs["traj"] = tree_map(lambda *xs: torch.stack(xs), *steps)
        new = CollectState(env_state=env_state, obs=obs, rng=cstate.rng, ep_ret=ep_ret, ep_len=ep_len,
                           policy_state=pstate)
        return new, bstate, outputs

    return seg


class Collector:
    """Collection over a :class:`VectorEnv`, optionally into a buffer."""

    def __init__(
        self,
        algo: Algorithm,
        venv: VectorEnv,
        buffer: ReplayBuffer | None = None,
        device: str | torch.device = "cuda",
        reward_metric=None,
    ):
        self.device = resolve_device(device)
        if venv.device != self.device or algo.device != self.device:
            raise ValueError(
                f"collector on {self.device}, env on {venv.device}, algorithm on {algo.device}"
            )
        self.algo = algo
        self.venv = venv
        self.buffer = buffer
        self.reward_metric = reward_metric

    def reset(self, generator: torch.Generator) -> CollectState:
        """Reset every env from ``generator``; the collector's own stream is
        forked from it."""
        env_state, obs = self.venv.reset(generator)
        n = self.venv.num_envs
        return CollectState(
            env_state=env_state,
            obs=obs,
            rng=fork_generator(generator),
            ep_ret=torch.zeros((n,), dtype=torch.float32, device=self.device),
            ep_len=torch.zeros((n,), dtype=torch.int64, device=self.device),
            policy_state=self.algo.init_policy_state(n),
        )

    def example_transition(self, ts: TrainState, cstate: CollectState) -> Batch:
        """One eager env step to derive the buffer schema (one env's leaves,
        no batch dimension)."""
        g = make_generator(0, self.device)
        act, extras = self.algo.act_with_extras(ts, cstate.obs, g, False)
        _, res, _ = self.venv.step(cstate.env_state, self.algo.map_action(act), g)
        tr = Batch(
            obs=cstate.obs, act=act, rew=res.reward, terminated=res.terminated,
            truncated=res.truncated, obs_next=res.obs,
        )
        if extras:
            tr["policy"] = extras
        return tree_map(lambda x: x[0], tr)

    def collect(
        self,
        ts: TrainState,
        cstate: CollectState,
        bstate: ReplayBufferState | None,
        num_steps: int,
        explore: bool = True,
        explore_param: float = 0.0,
        random: bool = False,
    ) -> tuple[CollectState, ReplayBufferState | None, CollectStats]:
        """Collect ``num_steps`` steps per env; ``random`` acts uniformly at
        random (warm-up)."""
        seg = rollout_segment(self.algo, self.venv, self.buffer, num_steps, explore, random,
                              reward_metric=self.reward_metric)
        cstate, bstate, outputs = seg(ts, cstate, bstate, explore_param)
        return cstate, bstate, self.summarize(outputs, self.venv.num_envs * num_steps)

    @staticmethod
    def summarize(outputs: dict, n_steps: int) -> CollectStats:
        """Copy a segment's episode outputs to the host (one sync)."""
        done = outputs["done"].cpu().numpy()
        rets = outputs["ep_ret"].cpu().numpy()
        lens = outputs["ep_len"].cpu().numpy()
        return CollectStats(
            n_collected_steps=n_steps,
            n_collected_episodes=int(done.sum()),
            returns=rets[done],
            lens=lens[done],
        )

    def collect_episodes(
        self,
        ts: TrainState,
        generator: torch.Generator,
        n_episode: int,
        chunk_size: int = 128,
        explore: bool = False,
        explore_param: float = 0.0,
        max_chunks: int = 1000,
    ) -> CollectStats:
        """Collect exactly ``n_episode`` episodes from freshly reset envs.

        Env ``i`` contributes ``n // N + (i < n % N)`` episodes; surplus
        episodes are discarded, so fast envs do not bias the statistics.
        """
        n = self.venv.num_envs
        quota = np.full(n, n_episode // n, np.int64)
        quota[: n_episode % n] += 1
        cstate = self.reset(generator)
        seg = rollout_segment(self.algo, self.venv, None, chunk_size, explore, reward_metric=self.reward_metric)
        per_env_returns: list[list[float]] = [[] for _ in range(n)]
        per_env_lens: list[list[int]] = [[] for _ in range(n)]
        counts = np.zeros(n, np.int64)
        for _ in range(max_chunks):
            cstate, _, outputs = seg(ts, cstate, None, explore_param)
            done = outputs["done"].cpu().numpy()
            rets = outputs["ep_ret"].cpu().numpy()
            lens = outputs["ep_len"].cpu().numpy()
            for t, i in zip(*np.nonzero(done)):
                if counts[i] < quota[i]:
                    per_env_returns[i].append(float(rets[t, i]))
                    per_env_lens[i].append(int(lens[t, i]))
                counts[i] += 1
            if np.all(counts >= quota):
                break
        returns = np.asarray([r for lst in per_env_returns for r in lst], np.float64)
        lens_arr = np.asarray([l for lst in per_env_lens for l in lst], np.int64)
        return CollectStats(
            n_collected_steps=int(lens_arr.sum()),
            n_collected_episodes=int(returns.size),
            returns=returns,
            lens=lens_arr,
        )

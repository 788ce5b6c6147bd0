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

:meth:`Collector.collect` and each chunk of :meth:`Collector.collect_episodes`
run compiled, as the JAX package jits its ``_segment_fn``
(:func:`~tianshou_tpu_torch.utils.graphs.compile_step`, optimizers left as
built): on CUDA a CUDA graph per ``(num_steps, explore, record_traj,
random)`` over the train, collect and buffer states of its first call,
which it takes and returns as its static state; a call over other states
drops the graphs and captures again.  ``collect_episodes`` resets a static
collect state of the collector's own in place (its ``rng`` re-seeded from
the draw that a fresh reset's ``fork_generator`` makes), so that every test
phase replays the same chunk graph and draws what an eager one draws, and
reads each chunk's done flags, returns and lengths in one device-to-host
copy.  A returned trajectory is the caller's own copy.  On the CPU the
segments run eagerly.
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
from tianshou_tpu_torch.utils import trace
from tianshou_tpu_torch.utils.device import fork_generator, make_generator, resolve_device
from tianshou_tpu_torch.utils.graphs import StaticStep, compile_step, named_tensors

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
    (:func:`_default_reward_metric` by default).  ``explore_param`` is a
    float or a 0-d tensor (the captured superstep's, filled before each
    replay); the segment reads it only on the device."""
    actor = RandomPolicy(algo.action_space, algo.device) if random else algo
    reward_metric = reward_metric or _default_reward_metric

    def seg(ts: TrainState, cstate: CollectState, bstate, explore_param: float | torch.Tensor):
        obs, env_state = cstate.obs, cstate.env_state
        ep_ret, ep_len = cstate.ep_ret, cstate.ep_len
        pstate, init_pstate = cstate.policy_state, algo.init_policy_state(venv.num_envs)
        dones, rets, lens, steps = [], [], [], []
        for _ in range(num_steps):
            act, extras, pstate = actor.act_with_state(ts, obs, pstate, cstate.rng, explore, explore_param)
            env_state, res, carry_obs = venv.step(env_state, algo.map_action(act), cstate.rng)
            done = res.done
            pstate = tree_where(done, init_pstate, pstate)
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
        # the compiled collect() and collect_episodes() chunk, each with the
        # key of its next call (num_steps, explore, record_traj, random,
        # episodes), and the static collect state of the test phases
        self._compiled: dict[str, Any] = {}
        self._keys: dict[str, tuple] = {}
        self._episode_state: CollectState | None = None

    def reset(self, generator: torch.Generator, out: CollectState | None = None) -> CollectState:
        """Reset every env from ``generator``; the collector's own stream is
        forked from it.  With ``out`` (a state of this collector), the reset
        is written into ``out`` in place and ``out.rng`` re-seeded from the
        same draw; returns ``out``."""
        env_state, obs = self.venv.reset(generator)
        n = self.venv.num_envs
        if out is not None:
            init = self.algo.init_policy_state(n)
            dst = named_tensors((out.env_state, out.obs, out.policy_state))
            src = named_tensors((env_state, obs, init))
            with torch.no_grad():
                torch._foreach_copy_([t for _, t in dst], [t for _, t in src])
                out.ep_ret.zero_()
                out.ep_len.zero_()
            fork_generator(generator, out=out.rng)
            return out
        return CollectState(
            env_state=env_state,
            obs=obs,
            rng=fork_generator(generator),
            ep_ret=torch.zeros(self._reward_shape(env_state, obs), dtype=torch.float32, device=self.device),
            ep_len=torch.zeros((n,), dtype=torch.int64, device=self.device),
            policy_state=self.algo.init_policy_state(n),
        )

    def _reward_shape(self, env_state, obs) -> tuple[int, ...]:
        """The env's reward shape (``[N]``, or ``[N, A]`` per agent), from one
        random step on a throwaway generator, so that the episode-return
        carry has it from the reset on (the JAX collector probes it with
        ``jax.eval_shape``) and a captured superstep carries it unchanged."""
        g = make_generator(0, self.device)
        act = RandomPolicy(self.algo.action_space, self.device).act(None, obs, g, True)
        _, res, _ = self.venv.step(env_state, self.algo.map_action(act), g)
        return tuple(res.reward.shape)

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
        record_traj: bool = False,
        *,
        random: bool = False,
    ) -> tuple[CollectState, ReplayBufferState | None, CollectStats, Batch | None]:
        """Collect ``num_steps`` steps per env: ``(cstate, bstate, stats,
        traj)``, ``traj`` the segment's ``[T, N, ...]`` transitions with
        ``record_traj``, else ``None`` (the JAX package's signature and
        result).  ``random`` (keyword only) acts uniformly at random
        (warm-up)."""
        step = self._step("collect", ts, cstate, bstate, (num_steps, explore, record_traj, random, False))
        _, cstate, bstate, outputs, _ = step(ts, cstate, bstate, cstate.rng, explore_param)
        stats = self.summarize(outputs, self.venv.num_envs * num_steps)
        traj = outputs.get("traj")
        if traj is not None and isinstance(step, StaticStep):
            traj = tree_map(torch.clone, traj)  # the caller's own: the next replay writes the graph's
        return cstate, bstate, stats, traj

    def _step(self, name: str, ts, cstate, bstate, key: tuple):
        """The compiled segment ``name`` ("collect" or "episodes") over
        ``(ts, cstate, bstate)``, set to run ``key``'s segment at its next
        call; made anew over other states (:mod:`utils.graphs`)."""
        step = self._compiled.get(name)
        if not isinstance(step, StaticStep) or any(a is not b for a, b in zip(step.states, (ts, cstate, bstate))):
            step = self._compiled[name] = compile_step(
                lambda *args: self._run_segment(self._keys[name], *args), self.device, ts, cstate, bstate,
                key=lambda: self._keys[name], prepare_optimizers=False, name=f"collect.{name}")
        self._keys[name] = key
        return step

    def _run_segment(self, key: tuple, ts, cstate, bstate, generator, explore_param):
        """The eager segment of ``key``: ``(ts, cstate, bstate, outputs,
        None)``; an "episodes" chunk packs its done flags, returns and
        lengths into one float64 ``[3, T, N]`` output."""
        num_steps, explore, record_traj, random, episodes = key
        seg = rollout_segment(self.algo, self.venv, None if episodes else self.buffer, num_steps, explore, random,
                              record_traj, reward_metric=self.reward_metric)
        cstate, bstate, outputs = seg(ts, cstate, bstate, explore_param)
        if episodes:
            outputs = {"episodes": torch.stack([outputs[k].to(torch.float64) for k in ("done", "ep_ret", "ep_len")])}
        return ts, cstate, bstate, outputs, None

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
        The reset is the tracer's span ``tianshou.test.reset``, and each
        chunk, its replay with its one device-to-host copy,
        ``tianshou.test.chunk`` (:mod:`~tianshou_tpu_torch.utils.trace`).
        """
        n = self.venv.num_envs
        quota = np.full(n, n_episode // n, np.int64)
        quota[: n_episode % n] += 1
        with trace.span("tianshou.test.reset"):
            cstate = self._episode_state = self.reset(generator, out=self._episode_state)
            step = self._step("episodes", ts, cstate, None, (chunk_size, explore, False, False, True))
        per_env_returns: list[list[float]] = [[] for _ in range(n)]
        per_env_lens: list[list[int]] = [[] for _ in range(n)]
        counts = np.zeros(n, np.int64)
        for _ in range(max_chunks):
            with trace.span("tianshou.test.chunk"):
                _, cstate, _, outputs, _ = step(ts, cstate, None, cstate.rng, explore_param)
                done, rets, lens = outputs["episodes"].cpu().numpy()  # the chunk's one device-to-host copy
            done = done > 0
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

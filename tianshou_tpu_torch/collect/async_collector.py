"""Asynchronous host collection: partial-wait env stepping (port of
``tianshou_tpu/collect/async_collector.py``).

Slow environments do not hold back fast ones.  Each env steps in its own
future on a thread pool; the collector waits for at least ``wait_num``
ready envs (or ``timeout``), acts for the ready ones (the policy sees the
whole fixed-shape observation batch; rows of envs still stepping are not
used), resubmits them, and stages transitions until the step budget is met.
A recurrent policy's per-env state is threaded as the device ``Collector``
threads it: advanced only for the envs dispatched, reset at each env's
episode end.  Staged transitions go into the buffer with ``add_masked``;
the stored action is the env's action, as in the JAX package.

Acting goes through the host collectors' compiled
:class:`~tianshou_tpu_torch.collect.host_collector.ActingStep` (the JAX
package's jitted acting step; one graph per ``explore`` on CUDA): the
policy sees the whole fixed ``[N]`` observation batch every round, and the
carry is a static tensor that the step advances in place for the rows of a
static ``[N]`` mask (``torch.where(mask, new, old)``, the JAX
``old.at[idx].set(new[idx])``), which the host writes each round.  The
staged rounds still cross one ``add_masked`` copy each, as the JAX
package's eager loop does.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch.algos.base import Algorithm, TrainState
from tianshou_tpu_torch.collect.collector import CollectStats
from tianshou_tpu_torch.collect.host_collector import ActingStep
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer import ReplayBuffer, ReplayBufferState
from tianshou_tpu_torch.data.tree import tree_leaves, tree_map
from tianshou_tpu_torch.envs.host import space_from_gym
from tianshou_tpu_torch.utils.device import resolve_device
from tianshou_tpu_torch.utils.graphs import own_storage

__all__ = ["AsyncHostVectorEnv", "AsyncHostCollector"]


class AsyncHostVectorEnv:
    """Per-env future-based stepping with partial waits."""

    is_host_env = True

    def __init__(
        self,
        env_fns: Sequence[Callable[[], Any]],
        wait_num: int | None = None,
        timeout: float | None = None,
        max_workers: int | None = None,
    ):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.wait_num = wait_num or max(1, self.num_envs // 2)
        self.timeout = timeout
        self.observation_space = space_from_gym(self.envs[0].observation_space)
        self.action_space = space_from_gym(self.envs[0].action_space)
        self.pool = ThreadPoolExecutor(max_workers=max_workers or self.num_envs)
        self._futures: dict[int, Future] = {}

    def _drain(self) -> None:
        """Cancel the steps not started and wait for the running ones."""
        for f in self._futures.values():
            f.cancel()
        wait(list(self._futures.values()))
        self._futures.clear()

    def reset(self, seed: int | None = None) -> np.ndarray:
        """Reset every env (env ``i`` with ``seed + i``) after the steps in
        flight end."""
        self._drain()
        seeds = [seed + i for i in range(self.num_envs)] if seed is not None else [None] * self.num_envs
        return np.stack([e.reset(seed=s)[0] for e, s in zip(self.envs, seeds)]).astype(np.float32)

    def step_async(self, env_id: int, action) -> None:
        """Submit one env's step; its result comes back from :meth:`wait`."""
        if env_id in self._futures:
            raise RuntimeError(f"env {env_id} is already stepping")

        def one(env=self.envs[env_id], act=action):
            obs, rew, term, trunc, _ = env.step(act)
            carry = env.reset()[0] if term or trunc else obs
            return obs, rew, term, trunc, carry

        self._futures[env_id] = self.pool.submit(one)

    def wait(self) -> list[tuple[int, tuple]]:
        """Block until at least ``wait_num`` steps in flight finish (with a
        ``timeout``: until it passes with at least one finished); returns
        ``[(env_id, (obs, rew, term, trunc, carry)), ...]``."""
        if not self._futures:
            return []
        want = min(self.wait_num, len(self._futures))
        done_set: set = set()
        while len(done_set) < want:
            done, _ = wait(list(self._futures.values()), timeout=self.timeout, return_when=FIRST_COMPLETED)
            done_set |= done
            if self.timeout is not None and done_set:
                break
        out = []
        for env_id in list(self._futures):
            f = self._futures[env_id]
            if f in done_set:
                out.append((env_id, f.result()))
                del self._futures[env_id]
        return out

    def close(self) -> None:
        """Wait for the steps in flight, stop the pool, close the envs."""
        self._drain()
        self.pool.shutdown(wait=True, cancel_futures=True)
        for e in self.envs:
            e.close()


class AsyncHostCollector:
    """Collector over :class:`AsyncHostVectorEnv`: acts for and re-dispatches
    only the ready envs."""

    is_host_collector = True

    def __init__(
        self,
        algo: Algorithm,
        venv: AsyncHostVectorEnv,
        buffer: ReplayBuffer | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        if algo.device != self.device:
            raise ValueError(f"collector on {self.device}, algorithm on {algo.device}")
        self.algo = algo
        self.venv = venv
        self.buffer = buffer
        self.obs: np.ndarray | None = None
        self.ep_ret = np.zeros(venv.num_envs)
        self.ep_len = np.zeros(venv.num_envs, np.int64)
        self.acting = ActingStep(algo, self.device)
        self._policy_state = None

    def _reset_carry(self, rows: slice | int = slice(None)) -> None:
        """The carry of ``rows`` back to the initial one, in place: the
        acting step's graphs read the carry where they were captured."""
        n = self.venv.num_envs
        init = self.algo.init_policy_state(n if isinstance(rows, slice) else 1)
        if self._policy_state is None:
            # a leaf of its own each (DRQN's zero carry is one tensor twice)
            self._policy_state = own_storage(init)
            return
        with torch.no_grad():
            for s, f in zip(tree_leaves(self._policy_state), tree_leaves(init)):
                s[rows].copy_(f if isinstance(rows, slice) else f[0])

    def reset(self, seed: int = 0) -> None:
        self.obs = self.venv.reset(seed)
        self.ep_ret[:] = 0
        self.ep_len[:] = 0
        self._ready = list(range(self.venv.num_envs))
        # per env, the action in flight and the observation it came from
        # (envs dispatched in different rounds differ)
        self._inflight_act: np.ndarray | None = None
        self._inflight_obs: np.ndarray | None = None
        self._reset_carry()
        self._has_state = len(tree_leaves(self._policy_state)) > 0

    def collect(
        self,
        ts: TrainState,
        bstate: ReplayBufferState | None,
        num_steps: int,
        generator: torch.Generator,
        explore: bool = True,
        explore_param: float = 0.0,
    ) -> tuple[ReplayBufferState | None, CollectStats]:
        """Collect at least ``num_steps`` transitions over all envs,
        whichever finish first; returns ``(bstate, stats)``."""
        if self.obs is None:
            raise RuntimeError("call reset() first")
        n = self.venv.num_envs
        collected = 0
        returns, lens = [], []
        staged: list[tuple[np.ndarray, dict]] = []
        acting = self.acting.begin(ts, self.obs, generator, explore, explore_param,
                                   policy_state=self._policy_state if self._has_state else ())
        while collected < num_steps:
            if self._ready:
                mask = np.zeros(n, bool)
                mask[self._ready] = True
                env_act = acting(self.obs, mask if self._has_state else None)
                if self._inflight_act is None:
                    self._inflight_act = env_act.copy()
                    self._inflight_obs = self.obs.copy()
                for i in self._ready:
                    self.venv.step_async(i, env_act[i])
                    self._inflight_act[i] = env_act[i]
                    self._inflight_obs[i] = self.obs[i]
                self._ready = []
            results = self.venv.wait()
            if not results:
                continue
            mask = np.zeros(n, bool)
            tr = {
                "obs": self._inflight_obs.copy(),
                "act": self._inflight_act.copy(),
                "rew": np.zeros(n, np.float32),
                "terminated": np.zeros(n, bool),
                "truncated": np.zeros(n, bool),
                "obs_next": self.obs.copy(),
            }
            for env_id, (obs, rew, term, trunc, carry) in results:
                mask[env_id] = True
                tr["rew"][env_id] = rew
                tr["terminated"][env_id] = term
                tr["truncated"][env_id] = trunc
                tr["obs_next"][env_id] = obs
                self.ep_ret[env_id] += rew
                self.ep_len[env_id] += 1
                if term or trunc:
                    returns.append(float(self.ep_ret[env_id]))
                    lens.append(int(self.ep_len[env_id]))
                    self.ep_ret[env_id] = 0
                    self.ep_len[env_id] = 0
                    if self._has_state:
                        self._reset_carry(env_id)  # a fresh episode starts from the initial carry
                self.obs[env_id] = carry
                self._ready.append(env_id)
            staged.append((mask, tr))
            collected += int(mask.sum())
        if self.buffer is not None and bstate is not None:
            for mask, tr in staged:
                tr_dev = Batch(tree_map(lambda x: torch.as_tensor(x, device=self.device), tr))
                bstate = self.buffer.add_masked(bstate, tr_dev, torch.as_tensor(mask, device=self.device))
        return bstate, CollectStats(
            n_collected_steps=collected,
            n_collected_episodes=len(returns),
            returns=np.asarray(returns),
            lens=np.asarray(lens, np.int64),
        )

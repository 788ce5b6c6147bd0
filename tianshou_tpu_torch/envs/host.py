"""Host-process vectorized environments (port of
``tianshou_tpu/envs/host.py``): N envs with the gymnasium API stepped by a
thread pool (MuJoCo and ALE release the GIL), feeding batched numpy
observations to the policy on the card.

Auto-reset keeps the on-device ``VectorEnv``'s semantics: the step's result
holds the terminal observation, and the returned carry observation is the
fresh episode's reset observation.  Float observations are stacked as
float32.  ``NormObsHostVectorEnv`` normalises observations with host-side
running statistics that a test env can take over from a training env.

``gymnasium`` is imported only to convert its spaces: an env whose spaces
are already the port's ``Box``/``Discrete``/``MultiDiscrete`` (a numpy
stand-in) runs without it.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from concurrent.futures import ThreadPoolExecutor
from typing import Any, NamedTuple

import numpy as np

from tianshou_tpu_torch.envs.spaces import Box, Discrete, MultiDiscrete
from tianshou_tpu_torch.utils.statistics import RunningMeanStd

__all__ = ["HostStepResult", "HostVectorEnv", "NormObsHostVectorEnv", "space_from_gym"]


def space_from_gym(space) -> Any:
    """The port's space spec for a gymnasium space (native specs pass
    through; a ``Dict`` becomes a plain dict of specs)."""
    if isinstance(space, (Discrete, Box, MultiDiscrete)):
        return space
    if isinstance(space, dict):
        return {k: space_from_gym(v) for k, v in space.items()}
    import gymnasium as gym

    if isinstance(space, gym.spaces.Dict):
        return {k: space_from_gym(v) for k, v in space.spaces.items()}
    if isinstance(space, gym.spaces.Discrete):
        return Discrete(int(space.n))
    if isinstance(space, gym.spaces.MultiDiscrete):
        return MultiDiscrete(tuple(int(n) for n in space.nvec))
    if isinstance(space, gym.spaces.Box):

        def bound(arr):
            # a scalar when uniform, else every per-dim value: map_action's
            # scaling depends on each one
            a = np.asarray(arr, np.float64)
            if a.size == 0 or np.all(a == a.flat[0]):
                return float(a.flat[0]) if a.size else 0.0
            return tuple(a.reshape(-1).tolist())

        return Box(low=bound(space.low), high=bound(space.high), shape=tuple(space.shape))
    raise TypeError(f"Unsupported gym space: {space}")


class HostStepResult(NamedTuple):
    obs: Any
    reward: np.ndarray
    terminated: np.ndarray
    truncated: np.ndarray


def _stack_obs(items: list) -> Any:
    """Stack per-env observations, dict observations leaf-wise; float
    observations as float32."""
    if isinstance(items[0], dict):
        return {k: _stack_obs([it[k] for it in items]) for k in items[0]}
    stacked = np.stack(items)
    return stacked.astype(np.float32, copy=False) if stacked.dtype.kind == "f" else stacked


class HostVectorEnv:
    """N gymnasium-API envs stepped by a thread pool, with auto-reset."""

    is_host_env = True

    def __init__(self, env_fns: Sequence[Callable[[], Any]], max_workers: int | None = None):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.observation_space = space_from_gym(self.envs[0].observation_space)
        self.action_space = space_from_gym(self.envs[0].action_space)
        self.pool = ThreadPoolExecutor(max_workers=max_workers or min(32, self.num_envs))

    def reset(self, seed: int | None = None) -> Any:
        """Reset every env, env ``i`` with ``seed + i``."""
        seeds = [seed + i for i in range(self.num_envs)] if seed is not None else [None] * self.num_envs
        return _stack_obs(list(self.pool.map(lambda es: es[0].reset(seed=es[1])[0], zip(self.envs, seeds))))

    def step(self, actions: np.ndarray) -> tuple[HostStepResult, Any]:
        """Step all envs; returns ``(the true transition, carry obs)``."""

        def one(args):
            env, act = args
            obs, rew, term, trunc, _ = env.step(act)
            carry = env.reset()[0] if term or trunc else obs
            return obs, rew, term, trunc, carry

        obs, rew, term, trunc, carry = zip(*self.pool.map(one, zip(self.envs, actions)))
        result = HostStepResult(
            _stack_obs(list(obs)),
            np.stack(rew).astype(np.float32),
            np.stack(term).astype(bool),
            np.stack(trunc).astype(bool),
        )
        return result, _stack_obs(list(carry))

    def close(self) -> None:
        for env in self.envs:
            env.close()
        self.pool.shutdown(wait=False)


class NormObsHostVectorEnv(HostVectorEnv):
    """Observations normalised by running statistics; ``update_rms=False``
    (a test env) keeps statistics set with :meth:`set_rms`."""

    def __init__(self, env_fns, update_rms: bool = True, **kwargs):
        super().__init__(env_fns, **kwargs)
        self.update_rms = update_rms
        self.rms = RunningMeanStd()

    def reset(self, seed: int | None = None) -> np.ndarray:
        obs = super().reset(seed)
        if self.update_rms:
            self.rms.update(obs)
        return self.rms.norm(obs).astype(np.float32)

    def step(self, actions):
        res, carry = super().step(actions)
        if self.update_rms:
            self.rms.update(res.obs)
        res = res._replace(obs=self.rms.norm(res.obs).astype(np.float32))
        return res, self.rms.norm(carry).astype(np.float32)

    def get_rms(self) -> RunningMeanStd:
        return self.rms

    def set_rms(self, rms: RunningMeanStd) -> None:
        self.rms = rms

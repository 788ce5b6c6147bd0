"""Environment factories for the high-level API (port of
``tianshou_tpu/highlevel/env.py``).

:class:`TorchEnvFactory` (the JAX package's ``JaxEnvFactory``) builds
on-device :class:`~tianshou_tpu_torch.envs.base.VectorEnv`\\ s from the
port's env registry (``backend="torch"``); :class:`GymEnvFactory` builds
host gymnasium envs (``backend="host"``), with ``gymnasium`` imported only
when it is given a task name; :class:`RemoteEnvFactory` connects to env
farms (``backend="host"``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any, Literal

import torch

from tianshou_tpu_torch.envs.base import TorchEnv, VectorEnv
from tianshou_tpu_torch.envs.classic import make_env
from tianshou_tpu_torch.envs.host import HostVectorEnv, NormObsHostVectorEnv
from tianshou_tpu_torch.envs.norm import NormObsVectorEnv
from tianshou_tpu_torch.envs.spaces import Space

__all__ = ["Environments", "EnvFactory", "TorchEnvFactory", "GymEnvFactory", "RemoteEnvFactory"]


@dataclasses.dataclass
class Environments:
    """A train and a test vector env and their spaces."""

    train_venv: Any
    test_venv: Any
    observation_space: Space
    action_space: Space
    backend: Literal["torch", "host"]


class EnvFactory:
    def create_envs(self, num_train: int, num_test: int, device: str | torch.device = "cuda") -> Environments:
        raise NotImplementedError


class TorchEnvFactory(EnvFactory):
    """On-device envs from the port's registry (``make_env``; an unknown
    name raises ``KeyError`` here) or a given :class:`TorchEnv`."""

    def __init__(self, env: str | TorchEnv, obs_norm: bool = False):
        self.env = make_env(env) if isinstance(env, str) else env
        self.obs_norm = obs_norm

    def create_envs(self, num_train: int, num_test: int, device: str | torch.device = "cuda") -> Environments:
        if self.obs_norm:
            train = NormObsVectorEnv(self.env, num_train, update_rms=True, device=device)
            test = NormObsVectorEnv(self.env, num_test, update_rms=False, device=device)
        else:
            train = VectorEnv(self.env, num_train, device=device)
            test = VectorEnv(self.env, num_test, device=device)
        return Environments(
            train_venv=train,
            test_venv=test,
            observation_space=self.env.observation_space,
            action_space=self.env.action_space,
            backend="torch",
        )


class RemoteEnvFactory(EnvFactory):
    """Env farms on other machines (:mod:`~tianshou_tpu_torch.envs.remote`):
    ``train_addresses`` and ``test_addresses`` are ``"host:port"``
    endpoints, and the env counts are the farms' own (``num_train`` and
    ``num_test`` must match them, or be 0 or less to take them as they
    are).  A farm serves one learner connection at a time, so the train and
    test envs come from different farms."""

    def __init__(self, train_addresses: list[str], test_addresses: list[str]):
        self.train_addresses = train_addresses
        self.test_addresses = test_addresses

    def create_envs(self, num_train: int, num_test: int, device: str | torch.device = "cuda") -> Environments:
        from tianshou_tpu_torch.envs.remote import RemoteVectorEnv

        train = RemoteVectorEnv(self.train_addresses)
        test = RemoteVectorEnv(self.test_addresses)
        for venv, want, kind in ((train, num_train, "train"), (test, num_test, "test")):
            if want > 0 and venv.num_envs != want:
                train.close()
                test.close()
                raise ValueError(f"{kind} farms host {venv.num_envs} envs, the configuration asks for {want}")
        return Environments(
            train_venv=train,
            test_venv=test,
            observation_space=train.observation_space,
            action_space=train.action_space,
            backend="host",
        )


class GymEnvFactory(EnvFactory):
    """Host gymnasium envs (MuJoCo, Atari, ...), stepped in threads; the
    algorithm acts on ``device``."""

    def __init__(self, task: str | Callable[[], Any], obs_norm: bool = False, env_kwargs: dict | None = None):
        if isinstance(task, str):
            import gymnasium as gym

            kwargs = env_kwargs or {}
            self.make = lambda: gym.make(task, **kwargs)
        else:
            self.make = task
        self.obs_norm = obs_norm

    def create_envs(self, num_train: int, num_test: int, device: str | torch.device = "cuda") -> Environments:
        cls = NormObsHostVectorEnv if self.obs_norm else HostVectorEnv
        train = cls([self.make for _ in range(num_train)])
        test = cls([self.make for _ in range(num_test)])
        if self.obs_norm:
            test.update_rms = False
            test.set_rms(train.get_rms())  # one shared object: the test envs see the live statistics
        return Environments(
            train_venv=train,
            test_venv=test,
            observation_space=train.observation_space,
            action_space=train.action_space,
            backend="host",
        )

"""Observation-normalising vectorized env (port of ``tianshou_tpu/envs/norm.py``).

Running mean/std normalisation of observations that updates during training
and stays frozen for test envs.  The running statistics
(:class:`~tianshou_tpu_torch.utils.statistics.RunningMeanStdState`) travel in
the env state as ``(inner_state, rms)``, so they stay on the device through
the rollout; :meth:`NormObsVectorEnv.get_rms` and
:meth:`NormObsVectorEnv.with_rms` hand them from a training env's state to a
frozen test env's.
"""

from __future__ import annotations

from typing import Any

import torch

from tianshou_tpu_torch.envs.base import StepResult, TorchEnv, VectorEnv
from tianshou_tpu_torch.utils.statistics import RunningMeanStdState, rms_init, rms_normalize, rms_update

__all__ = ["NormObsVectorEnv"]


class NormObsVectorEnv(VectorEnv):
    def __init__(
        self,
        env: TorchEnv,
        num_envs: int,
        update_rms: bool = True,
        clip: float = 10.0,
        device: str | torch.device = "cuda",
    ):
        super().__init__(env, num_envs, device=device)
        self.update_rms = update_rms
        self.clip = clip

    def reset(self, generator: torch.Generator) -> tuple[Any, torch.Tensor]:
        inner_state, obs = super().reset(generator)
        rms = rms_init(tuple(obs.shape[1:]), self.device)
        if self.update_rms:
            rms = rms_update(rms, obs)
        return (inner_state, rms), rms_normalize(rms, obs, self.clip)

    def step(self, state: Any, action: torch.Tensor, generator: torch.Generator):
        inner_state, rms = state
        inner_state, res, carry_obs = super().step(inner_state, action, generator)
        if self.update_rms:
            rms = rms_update(rms, res.obs)
        # the carried observation is normalised with the updated statistics too
        res = StepResult(rms_normalize(rms, res.obs, self.clip), res.reward, res.terminated, res.truncated)
        return (inner_state, rms), res, rms_normalize(rms, carry_obs, self.clip)

    @staticmethod
    def get_rms(env_state: Any) -> RunningMeanStdState:
        return env_state[1]

    @staticmethod
    def with_rms(env_state: Any, rms: RunningMeanStdState) -> Any:
        return (env_state[0], rms)

"""Declarative sampling configuration (port of
``tianshou_tpu/highlevel/config.py``)."""

from __future__ import annotations

import dataclasses

from tianshou_tpu_torch.utils.repr import DataclassPPrintMixin

__all__ = ["SamplingConfig"]


@dataclasses.dataclass
class SamplingConfig(DataclassPPrintMixin):
    """Training-loop sampling parameters, field for field the JAX
    package's."""

    num_epochs: int = 10
    step_per_epoch: int = 30000
    batch_size: int = 64
    num_train_envs: int = 16
    num_test_envs: int = 10
    buffer_size: int = 20000
    step_per_collect: int = 2048
    repeat_per_collect: int = 10
    update_per_step: float = 1.0
    start_timesteps: int = 0
    start_timesteps_random: bool = True
    episode_per_test: int = 10
    replay_buffer_stack_num: int = 1
    prioritized_buffer: bool = False
    prio_alpha: float = 0.6
    prio_beta: float = 0.4

    def train_seed(self, seed: int) -> int:
        return seed

    def test_seed(self, seed: int) -> int:
        # a seed stream for the test envs disjoint from the train envs'
        return seed + 10_000

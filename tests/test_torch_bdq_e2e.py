"""The port's copy of the JAX package's BDQ learning-threshold test
(tests/test_distributional_e2e.py ``test_bdq_discretized_pendulum``: >= -300
on Pendulum with 11 actions per dimension as a one-branch MultiDiscrete):
the same configuration through the port's whole pipeline on the CPU."""

import pytest
import torch

from tianshou_tpu_torch.algos.bdq import BDQ
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import Pendulum
from tianshou_tpu_torch.envs.wrappers import ContinuousToDiscrete
from tianshou_tpu_torch.networks.common import BranchingQNet
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    yield
    torch.set_num_threads(threads)


def test_bdq_discretized_pendulum(one_thread):
    env = ContinuousToDiscrete(Pendulum(), action_per_dim=11, force_multidiscrete=True)
    algo = BDQ(
        BranchingQNet(3, (128, 128), num_branches=1, actions_per_branch=11),
        env.action_space,
        gamma=0.99,
        target_update_freq=320,
        device="cpu",
    )
    buffer = ReplayBuffer(capacity=2000, num_envs=10)
    trainer = OffPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, 10, device="cpu"), device="cpu"),
        buffer,
        max_epoch=5,
        step_per_epoch=6000,
        step_per_collect=100,
        update_per_step=0.1,
        batch_size=128,
        train_param_fn=lambda e, s: 0.1,
        stop_fn=lambda rew: rew >= -300,
        warmup_steps=1000,
        seed=0,
        device="cpu",
    )
    info = trainer.run()
    assert info.stop_triggered, f"best={info.best_reward}"

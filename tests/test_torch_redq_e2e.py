"""The port's copy of the JAX package's REDQ learning-threshold test
(tests/test_utils_misc.py ``test_redq_pendulum``: >= -250 on Pendulum):
the same configuration through the port's whole pipeline on the CPU."""

import pytest
import torch

from tianshou_tpu_torch.algos.redq import REDQ
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import Pendulum
from tianshou_tpu_torch.networks.continuous import CriticEnsemble, GaussianActor
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    yield
    torch.set_num_threads(threads)


def test_redq_pendulum(one_thread):
    env = Pendulum()
    algo = REDQ(
        GaussianActor(3, (128, 128), 1, conditioned_sigma=True),
        CriticEnsemble(3, 1, (128, 128), num_critics=10),
        env.action_space,
        ensemble_size=10,
        subset_size=2,
        actor_delay=20,
        auto_alpha=True,
        device="cpu",
    )
    buffer = ReplayBuffer(capacity=2000, num_envs=10)
    trainer = OffPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, 10, device="cpu"), device="cpu"),
        buffer,
        max_epoch=8,
        step_per_epoch=6000,
        step_per_collect=100,
        update_per_step=0.25,
        batch_size=256,
        stop_fn=lambda rew: rew >= -250,
        warmup_steps=1000,
        seed=0,
        device="cpu",
    )
    info = trainer.run()
    assert info.stop_triggered, f"best={info.best_reward}"

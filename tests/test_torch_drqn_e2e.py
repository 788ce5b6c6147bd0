"""The port's copy of the JAX package's DRQN learning-threshold test
(tests/test_distributional_e2e.py ``test_drqn_cartpole``: >= 180 on
CartPole, with the LSTM carries threaded through the collector and
histories of 4 rebuilt for learning), through the port's whole pipeline on
the CPU.  It takes about 91 s alone, so it is marked ``slow`` and stays out
of the default run; tests/test_torch_recurrent.py holds DRQN's updates and
its recurrent segment against the JAX package there."""

import pytest
import torch

from tianshou_tpu_torch.algos.drqn import DRQN
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.networks.common import RecurrentQNet
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    yield
    torch.set_num_threads(threads)


@pytest.mark.slow
def test_drqn_cartpole(one_thread):
    env = CartPole()
    algo = DRQN(RecurrentQNet(4, hidden_size=128, num_actions=2), env.action_space, stack_num=4, gamma=0.95,
                target_update_freq=320, device="cpu")
    # tests/test_distributional_e2e.py ``_train`` with max_epoch=12
    buffer = ReplayBuffer(capacity=2000, num_envs=10)
    trainer = OffPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, 10, device="cpu"), device="cpu"),
        buffer,
        max_epoch=12,
        step_per_epoch=8000,
        step_per_collect=100,
        update_per_step=0.1,
        batch_size=64,
        train_param_fn=lambda e, s: 0.1,
        stop_fn=lambda rew: rew >= 180,
        warmup_steps=1000,
        seed=2,
        device="cpu",
    )
    info = trainer.run()
    assert info.stop_triggered, f"best={info.best_reward}"

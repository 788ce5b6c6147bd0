"""The port's copies of the discrete cases of tests/test_offline_e2e.py, at
the same settings and seeds, on the CPU: the port's own DQN is trained to
195 on the on-device CartPole (seed 0), 200 more steps of 10 envs at
epsilon 0.1 go into its [10, 2000] ring, and from that ring DiscreteBCQ,
DiscreteCQL (on QRDQN, 32 quantiles) and DiscreteCRR each reach a test
reward of 120 through ``OfflineTrainer`` (at most 6 epochs of 2000 updates
of batch 64)."""

import pytest
import torch

from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.algos.offline import DiscreteBCQ, DiscreteCQL, DiscreteCRR
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.networks.discrete import QRDQNNet
from tianshou_tpu_torch.trainer.offline import OfflineTrainer
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cartpole_data():
    torch.set_num_threads(1)
    env = CartPole()
    algo = DQN(QNet(4, (128, 128, 128), 2), env.action_space, gamma=0.9, n_step=3, target_update_freq=320,
               device="cpu")
    buffer = ReplayBuffer(capacity=2000, num_envs=10)
    trainer = OffPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, 10, device="cpu"), device="cpu"),
        buffer,
        max_epoch=5,
        step_per_epoch=10000,
        step_per_collect=100,
        update_per_step=0.1,
        batch_size=64,
        train_param_fn=lambda e, s: 0.1,
        stop_fn=lambda rew: rew >= 195,
        warmup_steps=1000,
        seed=0,
        device="cpu",
    )
    info = trainer.run()
    assert info.stop_triggered
    col = Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu")
    cstate = col.reset(torch.Generator().manual_seed(9))
    _, bstate, _, _ = col.collect(trainer.train_state, cstate, trainer.buffer_state, num_steps=200, explore=True,
                               explore_param=0.1)
    return buffer, bstate


def _run_offline(algo, buffer, bstate, threshold=120, max_epoch=6, update_per_epoch=2000, batch_size=64):
    trainer = OfflineTrainer(
        algo, buffer, bstate, Collector(algo, VectorEnv(CartPole(), 10, device="cpu"), device="cpu"),
        max_epoch=max_epoch, update_per_epoch=update_per_epoch, batch_size=batch_size, episode_per_test=10,
        stop_fn=lambda rew: rew >= threshold, seed=0, device="cpu")
    info = trainer.run()
    print(type(algo).__name__, info.epoch, info.gradient_step, info.best_reward, round(info.duration, 1))
    assert info.best_reward >= threshold, f"best={info.best_reward}"
    return info


def test_discrete_bcq_cartpole(cartpole_data):
    algo = DiscreteBCQ(QNet(4, (128, 128), 2), QNet(4, (128, 128), 2), CartPole().action_space,
                       target_update_freq=500, unlikely_action_threshold=0.3, device="cpu")
    _run_offline(algo, *cartpole_data)


def test_discrete_cql_cartpole(cartpole_data):
    algo = DiscreteCQL(QRDQNNet(4, (128, 128), 2, num_quantiles=32), CartPole().action_space, num_quantiles=32,
                       min_q_weight=10.0, gamma=0.95, n_step=3, target_update_freq=320, device="cpu")
    _run_offline(algo, *cartpole_data)


def test_discrete_crr_cartpole(cartpole_data):
    algo = DiscreteCRR(QNet(4, (128, 128), 2), QNet(4, (128, 128), 2), CartPole().action_space,
                       policy_improvement_mode="exp", target_update_freq=500, device="cpu")
    _run_offline(algo, *cartpole_data)

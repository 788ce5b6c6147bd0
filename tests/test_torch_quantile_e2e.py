"""The port's copies of the JAX package's IQN and FQF learning-threshold
tests (tests/test_distributional_e2e.py ``test_iqn_cartpole`` and
``test_fqf_cartpole``: >= 180 on CartPole, FQF over 8 epochs): the same
configurations through the port's whole pipeline on the CPU.  The FQF copy
runs all 8 epochs when it misses (about 155 s), so it is marked ``slow``
and stays out of the default run; ROADMAP.md records its result."""

import pytest
import torch

from tianshou_tpu_torch.algos.qrdqn import FQF, IQN
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.networks.discrete import FractionProposalNetwork, FullQuantileFunction, ImplicitQuantileNetwork
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    yield
    torch.set_num_threads(threads)


def _train(algo, max_epoch=4):
    """tests/test_distributional_e2e.py ``_train``."""
    env = CartPole()
    buffer = ReplayBuffer(capacity=2000, num_envs=10)
    trainer = OffPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, 10, device="cpu"), device="cpu"),
        buffer,
        max_epoch=max_epoch,
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


def test_iqn_cartpole(one_thread):
    algo = IQN(ImplicitQuantileNetwork(4, (128, 128), 2), CartPole().action_space, sample_size=32,
               online_sample_size=8, target_sample_size=8, gamma=0.95, n_step=3, target_update_freq=320, device="cpu")
    _train(algo)


@pytest.mark.slow
def test_fqf_cartpole(one_thread):
    algo = FQF(FullQuantileFunction(4, (128, 128), 2), FractionProposalNetwork(128, 32), CartPole().action_space,
               num_fractions=32, fraction_lr=2.5e-9, lr=3e-3, gamma=0.95, n_step=3, target_update_freq=320,
               device="cpu")
    _train(algo, max_epoch=8)

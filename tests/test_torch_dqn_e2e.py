"""The port's copy of tests/test_dqn_e2e.py: DQN reaches CartPole reward >=
195 through the whole pipeline (collector -> ring buffer -> presampled
supersteps -> test episodes), with the same configuration, on the CPU."""

import torch

from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


def test_dqn_cartpole_reaches_threshold():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    try:
        env = CartPole()
        algo = DQN(
            network=QNet(env.observation_space.shape, (128, 128, 128), 2),
            action_space=env.action_space,
            lr=1e-3,
            gamma=0.9,
            n_step=3,
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
            step_per_epoch=10000,
            step_per_collect=100,
            update_per_step=0.1,
            batch_size=64,
            episode_per_test=10,
            train_param_fn=lambda epoch, step: 0.1,
            test_param=0.0,
            stop_fn=lambda rew: rew >= 195,
            warmup_steps=1000,
            seed=0,
            device="cpu",
        )
        info = trainer.run()
    finally:
        torch.set_num_threads(threads)
    assert info.stop_triggered, f"did not reach 195, best={info.best_reward}"
    assert info.best_reward >= 195

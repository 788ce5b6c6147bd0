"""The port's copies of the SAC and TD3 cases of tests/test_algos_e2e.py: each
reaches Pendulum reward >= -250 through the whole pipeline (on-device
Pendulum -> ring buffer -> presampled supersteps -> test episodes) at the
JAX test's configuration, on the CPU: 10 envs x 10 steps a superstep, 12
updates of batch 256, a 2000-slot ring per env, 1000 warm-up steps,
GaussianActor / DeterministicActor (128, 128) and twin critics (128, 128)."""

import pytest
import torch

from tianshou_tpu_torch.algos.ddpg import TD3
from tianshou_tpu_torch.algos.sac import SAC
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import Pendulum
from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor, GaussianActor
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


def _algo(kind, env):
    obs, act = env.observation_space.shape, env.action_space.shape[0]
    critic = CriticEnsemble(obs, act, (128, 128), num_critics=2)
    if kind == "sac":
        return SAC(GaussianActor(obs, (128, 128), act, conditioned_sigma=True), critic, env.action_space,
                   actor_lr=1e-3, critic_lr=1e-3, auto_alpha=True, device="cpu")
    return TD3(DeterministicActor(obs, (128, 128), act), critic, env.action_space,
               actor_lr=1e-3, critic_lr=1e-3, exploration_noise=0.1, device="cpu")


@pytest.mark.parametrize("kind", ["sac", "td3"])
def test_reaches_pendulum_threshold(kind):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    try:
        env = Pendulum()
        algo = _algo(kind, env)
        buffer = ReplayBuffer(capacity=2000, num_envs=10)
        trainer = OffPolicyTrainer(
            algo,
            Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu"),
            Collector(algo, VectorEnv(env, 10, device="cpu"), device="cpu"),
            buffer,
            max_epoch=8,
            step_per_epoch=6000,
            step_per_collect=100,
            update_per_step=0.125,
            batch_size=256,
            episode_per_test=10,
            stop_fn=lambda rew: rew >= -250,
            warmup_steps=1000,
            seed=0,
            device="cpu",
        )
        info = trainer.run()
    finally:
        torch.set_num_threads(threads)
    assert info.stop_triggered, f"did not reach -250, best={info.best_reward}"
    assert info.best_reward >= -250
    print(kind, info.epoch, info.env_step, info.best_reward, round(info.duration, 1))

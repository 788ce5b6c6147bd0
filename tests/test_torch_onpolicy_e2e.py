"""The port's copies of test_ppo_cartpole and test_a2c_cartpole in
tests/test_algos_e2e.py: PPO reaches CartPole reward >= 195 and A2C >= 180
through the whole on-policy pipeline (recorded rollout -> GAE -> repeat x
shuffled minibatches -> test episodes), with the same configurations, on
the CPU."""

import torch

from tianshou_tpu_torch.algos.a2c import A2C
from tianshou_tpu_torch.algos.ppo import PPO
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.networks.continuous import ValueNet
from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer


def _run_onpolicy(algo, env, threshold, repeat, max_epoch=8, step_per_epoch=30000, batch_size=256, seed=0):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    try:
        trainer = OnPolicyTrainer(
            algo,
            Collector(algo, VectorEnv(env, 16, device="cpu"), device="cpu"),
            Collector(algo, VectorEnv(env, 16, device="cpu"), device="cpu"),
            max_epoch=max_epoch,
            step_per_epoch=step_per_epoch,
            step_per_collect=2048,
            repeat_per_collect=repeat,
            batch_size=batch_size,
            episode_per_test=10,
            stop_fn=lambda rew: rew >= threshold,
            seed=seed,
            device="cpu",
        )
        info = trainer.run()
    finally:
        torch.set_num_threads(threads)
    assert info.stop_triggered, f"best={info.best_reward}"
    return info


def test_ppo_cartpole():
    env = CartPole()
    algo = PPO(
        QNet(4, (64, 64), 2),
        ValueNet(4, (64, 64)),
        env.action_space,
        lr=3e-4,
        gamma=0.99,
        gae_lambda=0.95,
        max_grad_norm=0.5,
        ent_coef=0.0,
        device="cpu",
    )
    assert _run_onpolicy(algo, env, 195, repeat=10).best_reward >= 195


def test_a2c_cartpole():
    env = CartPole()
    algo = A2C(
        QNet(4, (64, 64), 2),
        ValueNet(4, (64, 64)),
        env.action_space,
        lr=7e-4,
        gamma=0.99,
        gae_lambda=0.95,
        max_grad_norm=0.5,
        device="cpu",
    )
    assert _run_onpolicy(algo, env, 180, repeat=1).best_reward >= 180

"""The port's copy of the GAIL case of tests/test_offline_e2e.py:225-261, at
the same settings and seed, on the CPU: GAIL (PPO over ``GaussianActor``
and ``ValueNet`` (64, 64), a ``Critic`` (64, 64) discriminator, 2
discriminator steps a rollout) reaches a test reward of -500 on the
on-device Pendulum through ``OnPolicyTrainer``, with the HDF5 round trip of
the port's own SAC data as its expert data (tests/test_torch_offline_e2e.py's
fixture, shared by import)."""

from tests.test_torch_offline_e2e import one_thread, pendulum_data  # noqa: F401
from tianshou_tpu_torch.algos.gail import GAIL
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import Pendulum
from tianshou_tpu_torch.networks.continuous import Critic, GaussianActor, ValueNet
from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer


def test_gail_pendulum(pendulum_data):
    buffer, bstate = pendulum_data
    env = Pendulum()
    algo = GAIL(GaussianActor(3, (64, 64), 1), ValueNet(3, (64, 64)), env.action_space,
                disc_net=Critic(3, 1, (64, 64)), expert_buffer=buffer, expert_buffer_state=bstate, disc_lr=2.5e-4,
                disc_update_num=2, lr=3e-4, gamma=0.95, gae_lambda=0.95, max_grad_norm=0.5, ent_coef=0.0,
                device="cpu")
    trainer = OnPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, 16, device="cpu"), device="cpu"),
        Collector(algo, VectorEnv(env, 16, device="cpu"), device="cpu"),
        max_epoch=10, step_per_epoch=30000, step_per_collect=2048, repeat_per_collect=10, batch_size=256,
        episode_per_test=10, stop_fn=lambda rew: rew >= -500, seed=0, device="cpu")
    info = trainer.run()
    print("GAIL", info.epoch, info.env_step, info.best_reward, round(info.duration, 1))
    assert info.stop_triggered, f"best={info.best_reward}"
    assert {"disc_loss", "acc_pi", "acc_exp"} <= set(info.last_metrics)

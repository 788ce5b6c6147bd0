"""The port's copies of the continuous cases of tests/test_offline_e2e.py, at
the same settings and seeds, on the CPU: the port's own SAC is trained to
-250 on the on-device Pendulum (seed 1), 240 more exploring steps of 10
envs go into its [10, 2400] ring, and the ring round-trips through
``save_buffer_hdf5`` / ``load_buffer_hdf5``; from it BC, TD3BC and BCQ
each reach a test reward of -600 through ``OfflineTrainer`` (at most 6
epochs of 2000 updates of batch 256).  The copies of CQL and GAIL, on the
same data, are tests/test_torch_cql_e2e.py and tests/test_torch_gail_e2e.py:
apart, no file runs much past two minutes."""

import pytest
import torch

from tianshou_tpu_torch.algos.offline import BC, BCQ, TD3BC
from tianshou_tpu_torch.algos.sac import SAC
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.persistence import load_buffer_hdf5, save_buffer_hdf5
from tianshou_tpu_torch.envs.base import VectorEnv
from tianshou_tpu_torch.envs.classic import Pendulum
from tianshou_tpu_torch.networks.continuous import VAE, CriticEnsemble, DeterministicActor, GaussianActor, Perturbation
from tianshou_tpu_torch.trainer.offline import OfflineTrainer
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pendulum_data(tmp_path_factory):
    torch.set_num_threads(1)
    env = Pendulum()
    algo = SAC(GaussianActor(3, (128, 128), 1, conditioned_sigma=True), CriticEnsemble(3, 1, (128, 128), 2),
               env.action_space, auto_alpha=True, device="cpu")
    buffer = ReplayBuffer(capacity=2400, num_envs=10)
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
        stop_fn=lambda rew: rew >= -250,
        warmup_steps=1000,
        seed=1,
        device="cpu",
    )
    info = trainer.run()
    assert info.stop_triggered
    col = Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu")
    cstate = col.reset(torch.Generator().manual_seed(7))
    _, bstate, _, _ = col.collect(trainer.train_state, cstate, trainer.buffer_state, num_steps=240, explore=True)
    path = str(tmp_path_factory.mktemp("data") / "pendulum.h5")
    save_buffer_hdf5(path, bstate)
    return buffer, load_buffer_hdf5(path, device="cpu")


def _run_offline(algo, buffer, bstate, env, threshold, max_epoch=6, update_per_epoch=2000, batch_size=256):
    trainer = OfflineTrainer(
        algo, buffer, bstate, Collector(algo, VectorEnv(env, 10, device="cpu"), device="cpu"),
        max_epoch=max_epoch, update_per_epoch=update_per_epoch, batch_size=batch_size, episode_per_test=10,
        stop_fn=lambda rew: rew >= threshold, seed=0, device="cpu")
    info = trainer.run()
    print(type(algo).__name__, info.epoch, info.gradient_step, info.best_reward, round(info.duration, 1))
    assert info.best_reward >= threshold, f"best={info.best_reward}"
    assert info.env_step == info.gradient_step * batch_size
    return info


def test_bc_pendulum(pendulum_data):
    env = Pendulum()
    _run_offline(BC(DeterministicActor(3, (128, 128), 1), env.action_space, lr=1e-3, device="cpu"),
                 *pendulum_data, env, -600)


def test_td3_bc_pendulum(pendulum_data):
    env = Pendulum()
    algo = TD3BC(DeterministicActor(3, (128, 128), 1), CriticEnsemble(3, 1, (128, 128), 2), env.action_space,
                 bc_alpha=2.5, gamma=0.99, device="cpu")
    _run_offline(algo, *pendulum_data, env, -600)


def test_bcq_pendulum(pendulum_data):
    env = Pendulum()
    algo = BCQ(Perturbation(3, (128, 128), 1, phi=0.05), CriticEnsemble(3, 1, (128, 128), 2),
               VAE(3, (128, 128), 1, latent_dim=2), env.action_space, device="cpu")
    _run_offline(algo, *pendulum_data, env, -600)

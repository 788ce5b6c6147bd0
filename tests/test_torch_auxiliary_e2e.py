"""The port's copies of the HER, ICM and PSRL learning tests of
tests/test_utils_misc.py:164-300, at the same settings and seeds, on the
CPU:

- DDPG on a ``HERReplayBuffer`` (horizon 16, future_k 8) reaches -9 on a
  sparse-reward 1-D goal task, a torch copy of tests/helpers.py's
  ``GoalReachEnv`` written here;
- ICM around DQN reaches 180 on CartPole;
- PSRL reaches 300 on NChain through ``OnPolicyTrainer``.
"""

from typing import NamedTuple

import pytest
import torch

from tianshou_tpu_torch.algos.ddpg import DDPG
from tianshou_tpu_torch.algos.dqn import DQN
from tianshou_tpu_torch.algos.icm import ICM, ICMNet
from tianshou_tpu_torch.algos.psrl import PSRL
from tianshou_tpu_torch.collect.collector import Collector
from tianshou_tpu_torch.data.buffer import ReplayBuffer
from tianshou_tpu_torch.data.her import HERReplayBuffer
from tianshou_tpu_torch.envs.base import StepResult, TorchEnv, VectorEnv
from tianshou_tpu_torch.envs.classic import CartPole, NChain
from tianshou_tpu_torch.envs.spaces import Box
from tianshou_tpu_torch.networks.common import QNet
from tianshou_tpu_torch.networks.continuous import CriticEnsemble, DeterministicActor
from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer
from tianshou_tpu_torch.trainer.onpolicy import OnPolicyTrainer


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite runs in several worker processes
    yield
    torch.set_num_threads(threads)


class GoalState(NamedTuple):
    pos: torch.Tensor
    goal: torch.Tensor
    t: torch.Tensor


class GoalReachEnv(TorchEnv):
    """Sparse-reward 1-D goal reaching (tests/helpers.py ``GoalReachEnv``):
    obs ``[pos, achieved (= pos), desired (= goal)]``; reward -1 until the
    goal is within ``TOL``, then 0 and terminated; truncated after
    ``MAX_T`` steps."""

    SIZE, TOL, MAX_T = 8.0, 0.5, 16
    observation_space = Box(low=-10.0, high=10.0, shape=(3,))
    action_space = Box(low=-1.0, high=1.0, shape=(1,))

    def reset(self, generator, num_envs, device):
        goal = 1.0 + (self.SIZE - 1.0) * torch.rand(num_envs, generator=generator, device=device)
        state = GoalState(torch.zeros(num_envs, device=device), goal,
                          torch.zeros(num_envs, dtype=torch.int32, device=device))
        return state, self._obs(state)

    @staticmethod
    def _obs(s: GoalState) -> torch.Tensor:
        return torch.stack([s.pos, s.pos, s.goal], dim=1)

    def step(self, state: GoalState, action, generator=None):
        pos = torch.clamp(state.pos + action.reshape(-1), 0.0, self.SIZE)
        new = GoalState(pos, state.goal, state.t + 1)
        reached = (pos - state.goal).abs() <= self.TOL
        reward = torch.where(reached, 0.0, -1.0)
        return new, StepResult(self._obs(new), reward, reached, (new.t >= self.MAX_T) & ~reached)

    @staticmethod
    def compute_reward(achieved: torch.Tensor, desired: torch.Tensor) -> torch.Tensor:
        return torch.where((achieved[:, 0] - desired[:, 0]).abs() <= GoalReachEnv.TOL, 0.0, -1.0)


def test_her_ddpg_goal_reach():
    env = GoalReachEnv()
    algo = DDPG(DeterministicActor(3, (128, 128), 1), CriticEnsemble(3, 1, (128, 128), num_critics=1),
                env.action_space, gamma=0.95, exploration_noise=0.25, device="cpu")
    buffer = HERReplayBuffer(4000, 10, compute_reward_fn=GoalReachEnv.compute_reward, achieved_slice=(1, 2),
                             desired_slice=(2, 3), horizon=16, future_k=8.0)
    trainer = OffPolicyTrainer(
        algo, Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, 10, device="cpu"), device="cpu"), buffer,
        max_epoch=6, step_per_epoch=5000, step_per_collect=100, update_per_step=0.125, batch_size=256,
        stop_fn=lambda rew: rew >= -9, warmup_steps=2000, seed=0, device="cpu")
    info = trainer.run()
    print("HER DDPG", info.epoch, info.env_step, info.best_reward, round(info.duration, 1))
    assert info.stop_triggered, f"best={info.best_reward}"


def test_icm_dqn_cartpole():
    env = CartPole()
    inner = DQN(QNet(4, (128, 128), 2), env.action_space, gamma=0.95, n_step=1, target_update_freq=320,
                device="cpu")
    algo = ICM(inner, ICMNet(4, (64,), feature_dim=32, num_actions=2), lr=1e-3, reward_scale=0.01)
    buffer = ReplayBuffer(capacity=2000, num_envs=10)
    trainer = OffPolicyTrainer(
        algo, Collector(algo, VectorEnv(env, 10, device="cpu"), buffer, device="cpu"),
        Collector(algo, VectorEnv(env, 10, device="cpu"), device="cpu"), buffer,
        max_epoch=5, step_per_epoch=10000, step_per_collect=100, update_per_step=0.1, batch_size=64,
        train_param_fn=lambda e, s: 0.1, stop_fn=lambda rew: rew >= 180, warmup_steps=1000, seed=0, device="cpu")
    info = trainer.run()
    print("ICM DQN", info.epoch, info.env_step, info.best_reward, round(info.duration, 1))
    assert info.stop_triggered, f"best={info.best_reward}"
    assert "icm_loss" in info.last_metrics


def test_psrl_nchain():
    env = NChain()
    algo = PSRL(num_states=5, action_space=env.action_space, gamma=0.95, device="cpu")
    trainer = OnPolicyTrainer(
        algo, Collector(algo, VectorEnv(env, 8, device="cpu"), device="cpu"),
        Collector(algo, VectorEnv(env, 8, device="cpu"), device="cpu"),
        max_epoch=5, step_per_epoch=2000, step_per_collect=400, repeat_per_collect=1, batch_size=400,
        episode_per_test=8, stop_fn=lambda rew: rew >= 300, seed=0, device="cpu")
    info = trainer.run()
    print("PSRL", info.epoch, info.env_step, info.best_reward, round(info.duration, 1))
    assert info.stop_triggered, f"best={info.best_reward}"

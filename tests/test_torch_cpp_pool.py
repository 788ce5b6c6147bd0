"""The native env pool of the port (tianshou_tpu_torch/envs/cpp_pool.py)
against the JAX package's, on the CPU.

- The port compiles ``native/cpp_envpool.cpp`` into ``build/tianshou_tpu_torch/``
  and never touches ``native/libtpuenvpool.so``.
- The same task, seed and actions give bitwise-equal trajectories
  (observations, rewards, flags, carries across auto-resets) to the JAX
  ``CppVectorEnv`` on all five tasks.
- DQN through ``HostCollector`` over the pool for a short host-path run
  (the shape of ``examples/cpp_pool_dqn.py``).
"""

import hashlib
import math

import numpy as np
import pytest

from tianshou_tpu.envs.cpp_pool import CppVectorEnv as JaxCppVectorEnv
from tianshou_tpu_torch.envs import cpp_pool
from tianshou_tpu_torch.envs.cpp_pool import CppVectorEnv

TASKS = ["CartPole-v1", "Pendulum-v1", "MountainCar-v0", "Acrobot-v1", "Reacher2"]


def test_library_is_built_under_build_and_the_jax_binary_is_untouched():
    committed = cpp_pool.NATIVE_SOURCE.parent / "libtpuenvpool.so"
    before = hashlib.sha256(committed.read_bytes()).hexdigest()
    path = cpp_pool.build_native_lib()
    assert path.parent == cpp_pool.BUILD_DIR and path.is_file()
    assert path.parts[-3:-1] == ("build", "tianshou_tpu_torch")
    assert cpp_pool.build_native_lib() == path  # built once
    assert hashlib.sha256(committed.read_bytes()).hexdigest() == before


def _actions(space, n, rng):
    if hasattr(space, "n"):
        return rng.integers(0, space.n, n).astype(np.float32)
    return rng.uniform(-1.0, 1.0, (n, *space.shape)).astype(np.float32) * np.float32(space.high)


@pytest.mark.parametrize("task", TASKS)
def test_trajectories_bitwise_equal_to_jax(task):
    n, steps = 6, 520  # past every task's time limit
    jenv, tenv = JaxCppVectorEnv(task, n, seed=9, num_threads=2), CppVectorEnv(task, n, seed=9, num_threads=2)
    for t, j in ((tenv.observation_space, jenv.observation_space), (tenv.action_space, jenv.action_space)):
        assert type(t).__name__ == type(j).__name__ and vars(t) == vars(j)
    np.testing.assert_array_equal(tenv.reset(), jenv.reset())
    rng = np.random.default_rng(1)
    ends = 0
    for _ in range(steps):
        act = _actions(tenv.action_space, n, rng)
        jres, jcarry = jenv.step(act)
        tres, tcarry = tenv.step(act)
        for name in ("obs", "reward", "terminated", "truncated"):
            np.testing.assert_array_equal(getattr(tres, name), getattr(jres, name), err_msg=name)
        np.testing.assert_array_equal(tcarry, jcarry)
        ends += int((tres.terminated | tres.truncated).sum())
    assert ends > 0
    jenv.close()
    tenv.close()


def test_dqn_runs_through_the_pool():
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    train, test = CppVectorEnv("CartPole-v1", 8, seed=0), CppVectorEnv("CartPole-v1", 4, seed=99)
    algo = DQN(QNet(4, (32, 32), 2), train.action_space, lr=1e-3, gamma=0.9, n_step=3, target_update_freq=320,
               device="cpu")
    buf = ReplayBuffer(200, 8)
    trainer = OffPolicyTrainer(
        algo, HostCollector(algo, train, buf, device="cpu"), HostCollector(algo, test, device="cpu"), buf,
        max_epoch=1, step_per_epoch=160, step_per_collect=80, update_per_step=0.1, batch_size=32,
        episode_per_test=4, train_param_fn=lambda e, s: 0.1, warmup_steps=160, device="cpu")
    info = trainer.run()
    assert (info.env_step, info.gradient_step) == (160 + 160, 16)
    assert math.isfinite(info.last_metrics["loss"]) and info.best_reward >= 8
    assert not trainer.last_run_used_fused
    train.close()
    test.close()

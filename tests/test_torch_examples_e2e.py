"""The port's example scripts, part (c): end to end on the CPU.

- Each script's ``main([..., "--device", "cpu"])`` trains a tiny budget and
  prints the JAX script's summary line (the arguments of
  ``tests/test_examples_smoke.py`` for ``atari_dqn``, ``cpp_pool_dqn
  --bench``, ``box2d_dqn`` and ``mujoco_a2c``, cut further);
  ``highlevel_dqn``, which has no budget flags, runs at its defaults to its
  own stop.  The default ``TensorboardLogger`` writes under a temporary
  directory.
- Without CUDA each script raises at its default ``--device cuda``.
- ``make_d4rl_demo`` across the packages: the port's writer gives the JAX
  helper's schema (keys, dtypes, shapes, episodes ending at each env's
  block); its HDF5 file loads through the JAX package's ``buffer_from_d4rl``
  and the JAX helper's file through the port's, each with the same
  transitions as the other package's loader gives; ``offline_d4rl_cql``
  trains one short epoch on the port's file.
"""

import importlib.util

import jax
import numpy as np
import pytest
import torch
from test_torch_examples_flags import REPO, SCRIPTS, _one_torch_thread, port_module  # noqa: F401

TINY = {
    "atari_dqn": ["--fake-ale", "--max-epoch", "1", "--step-per-epoch", "40", "--warmup-steps", "20",
                  "--training-num", "2", "--test-num", "1", "--buffer-size", "200"],
    "box2d_dqn": ["--max-epoch", "1", "--step-per-epoch", "64", "--num-envs", "2", "--test-envs", "1",
                  "--stop-reward", "1e9", "--batch-size", "16"],
    "box2d_sac": ["--num-envs", "2", "--test-envs", "1", "--max-epoch", "1", "--step-per-epoch", "40",
                  "--batch-size", "16", "--start-timesteps", "20", "--buffer-size", "200", "--no-stop"],
    "cpp_pool_dqn": ["--num-envs", "4", "--max-epoch", "1", "--step-per-epoch", "200"],
    "dqn_cartpole": ["--num-envs", "4", "--max-epoch", "1", "--step-per-epoch", "200", "--step-per-collect", "40",
                     "--buffer-size", "400"],
    "dqn_minatar": ["--num-envs", "4", "--max-epoch", "1", "--step-per-epoch", "64", "--step-per-collect", "32",
                    "--buffer-size", "400", "--algo", "qrdqn", "--num-quantiles", "8"],
    "highlevel_dqn": [],
    "mujoco_a2c": ["--max-epoch", "1", "--step-per-epoch", "80", "--num-envs", "2", "--test-envs", "1"],
    "mujoco_ppo": ["--num-envs", "2", "--test-envs", "1", "--max-epoch", "1", "--step-per-epoch", "64",
                   "--step-per-collect", "64", "--repeat", "1", "--batch-size", "32"],
    "mujoco_reinforce": ["--num-envs", "2", "--test-envs", "1", "--max-epoch", "1", "--step-per-epoch", "64",
                         "--step-per-collect", "64"],
    # one step a env a collect: the fused fine cycle
    "mujoco_sac": ["--num-envs", "2", "--test-envs", "1", "--max-epoch", "1", "--step-per-epoch", "40",
                   "--step-per-collect", "1", "--batch-size", "16", "--start-timesteps", "20", "--buffer-size", "200"],
    "mujoco_td3": ["--num-envs", "2", "--test-envs", "1", "--max-epoch", "1", "--step-per-epoch", "40",
                   "--batch-size", "16", "--start-timesteps", "20", "--buffer-size", "200"],
    "mujoco_trpo": ["--num-envs", "2", "--test-envs", "1", "--max-epoch", "1", "--step-per-epoch", "64",
                    "--step-per-collect", "64", "--optim-critic-iters", "2"],
    "offline_d4rl_cql": ["{dataset}", "--max-epoch", "1", "--update-per-epoch", "5", "--batch-size", "16",
                         "--hidden", "32", "32", "--test-envs", "2"],
    "ppo_classic": ["--num-envs", "4", "--max-epoch", "1", "--step-per-epoch", "128", "--step-per-collect", "64",
                    "--repeat", "1", "--batch-size", "32"],
    "sac_pendulum": ["--num-envs", "4", "--max-epoch", "1", "--step-per-epoch", "80", "--batch-size", "16"],
}
SUMMARY = {
    "atari_dqn": "DQN/ALE/Pong-v5: best=", "box2d_dqn": "DQN/LunarLander-v3: best=",
    "box2d_sac": "SAC/BipedalWalker-v3: best=", "cpp_pool_dqn": "DQN/CartPole-v1 (cpp_pool): best=",
    "dqn_cartpole": "best_reward=", "dqn_minatar": "game=breakout best_reward=", "highlevel_dqn": "best=",
    "mujoco_a2c": "A2C/HalfCheetah-v4: best=", "mujoco_ppo": "PPO/HalfCheetah-v4: best=",
    "mujoco_reinforce": "REINFORCE/HalfCheetah-v4: best=", "mujoco_sac": "SAC/HalfCheetah-v4: best=",
    "mujoco_td3": "TD3/HalfCheetah-v4: best=", "mujoco_trpo": "TRPO/HalfCheetah-v4: best=",
    "offline_d4rl_cql": "CQL/Pendulum-v1 from demo.h5: best=", "ppo_classic": "ppo/Pendulum-v1: best=",
    "sac_pendulum": "sac: best_reward=",
}
JAX_DEMO = importlib.util.spec_from_file_location("jax_make_d4rl_demo", REPO / "tests" / "make_d4rl_demo.py")


def _jax_demo():
    module = importlib.util.module_from_spec(JAX_DEMO)
    JAX_DEMO.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def demo_files(tmp_path_factory):
    """``(the port's HDF5 file, the JAX helper's HDF5 file)``, 400 steps each."""
    root = tmp_path_factory.mktemp("d4rl")
    port_module("make_d4rl_demo").main([str(root / "demo.h5"), "--steps", "400", "--device", "cpu"])
    _jax_demo().main([str(root / "jax_demo.h5"), "--steps", "400"])
    return str(root / "demo.h5"), str(root / "jax_demo.h5")


def test_scripts_all_have_a_tiny_run():
    assert sorted(TINY) == sorted(SUMMARY) == SCRIPTS


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_runs_end_to_end_on_the_cpu(name, demo_files, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the default log directories
    argv = [a.format(dataset=demo_files[0]) for a in TINY[name]]
    info = port_module(name).main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert SUMMARY[name] in out, out[-2000:]
    assert info.env_step > 0 or info.gradient_step > 0
    assert np.isfinite(info.best_reward)
    if name == "highlevel_dqn":  # its own stop, the reference's threshold
        assert info.best_reward >= 195


def test_cpp_pool_bench_mode_prints_its_three_rows(capsys):
    assert port_module("cpp_pool_dqn").main(["--bench", "--num-envs", "4", "--bench-steps", "200"]) is None
    out = capsys.readouterr().out
    for row in ("cpp_pool CartPole-v1", "host_venv CartPole-v1", "cpp_pool Reacher2"):
        assert row in out, out[-1000:]


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_raises_at_the_default_device_without_cuda(name, demo_files, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    argv = [a.format(dataset=demo_files[0]) for a in TINY[name]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_module(name).main(argv)


def test_make_d4rl_demo_writes_the_jax_helpers_schema():
    port = port_module("make_d4rl_demo").generate(400, seed=0, device="cpu")
    ref = _jax_demo().generate(400, seed=0)
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert (port[k].dtype, port[k].shape) == (ref[k].dtype, ref[k].shape), k
    # 8 envs x 50 steps, each env's block contiguous and ended by a timeout
    # (Pendulum's episodes last 200 steps); raw actions in the policy's
    # [-1, 1], rewards in Pendulum's [-16.27, 0], as the JAX helper's
    for data in (port, ref):
        np.testing.assert_array_equal(np.flatnonzero(data["timeouts"]), np.arange(1, 9) * 50 - 1)
        assert not data["terminals"].any()
        assert np.abs(data["actions"]).max() <= 1.0 and np.abs(data["observations"][:, :2]).max() <= 1.0
        assert -16.28 <= data["rewards"].min() and data["rewards"].max() <= 0.0
    np.testing.assert_array_equal(port["observations"][1:50], port["next_observations"][:49])


def test_d4rl_files_cross_the_packages(demo_files):
    from tianshou_tpu.data.persistence import buffer_from_d4rl as jax_buffer_from_d4rl
    from tianshou_tpu_torch.data.persistence import buffer_from_d4rl

    for path in demo_files:
        (jbuf, jstate), (tbuf, tstate) = jax_buffer_from_d4rl(path), buffer_from_d4rl(path, device="cpu")
        assert (tbuf.capacity, tbuf.num_envs) == (jbuf.capacity, jbuf.num_envs) == (400, 1)
        jstorage = jax.tree.map(np.asarray, dict(jstate.storage))
        assert sorted(tstate.storage) == sorted(jstorage)
        for k, ref in jstorage.items():
            np.testing.assert_array_equal(tstate.storage[k].numpy(), ref, err_msg=k)
        np.testing.assert_array_equal(tstate.size.numpy(), np.asarray(jstate.size))

"""DQN CartPole through the native C++ env pool, end to end (port of
``examples/cpp_pool_dqn.py``), and a ``--bench`` mode that compares the raw
env-step rate of the pool with the gymnasium-based ``HostVectorEnv`` on the
same task (the reference's EnvPool claim), beside the pool's costly
simulator, ``Reacher2`` (RK4, 4 substeps of a 2-link manipulator a control
step, ``native/cpp_envpool.cpp``).  The pool is compiled with ``g++`` at
first use.  ``--bench`` needs gymnasium; the training mode does not.

    python -m tianshou_tpu_torch.examples.cpp_pool_dqn [--bench] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from tianshou_tpu_torch.examples import run


def bench(num_envs: int, steps: int) -> list[tuple[str, float]]:
    """``(row, env-steps/s)`` for the pool on CartPole-v1, a gymnasium
    ``HostVectorEnv`` on CartPole-v1 and the pool on Reacher2."""
    import gymnasium as gym
    import numpy as np

    from tianshou_tpu_torch.envs.cpp_pool import CppVectorEnv
    from tianshou_tpu_torch.envs.host import HostVectorEnv

    rows = []

    def time_env(name, env, act_fn):
        try:
            env.reset(seed=0)
            act = act_fn()
            for _ in range(10):  # warm-up
                env.step(act)
            t0 = time.perf_counter()
            for _ in range(steps):
                env.step(act_fn())
            rows.append((name, num_envs * steps / (time.perf_counter() - t0)))
        finally:
            env.close()

    rng = np.random.default_rng(0)
    time_env("cpp_pool CartPole-v1", CppVectorEnv("CartPole-v1", num_envs, seed=0),
             lambda: rng.integers(0, 2, num_envs))
    time_env("host_venv CartPole-v1 (gymnasium)", HostVectorEnv([lambda: gym.make("CartPole-v1")] * num_envs),
             lambda: rng.integers(0, 2, num_envs))
    time_env("cpp_pool Reacher2 (RK4 manipulator)", CppVectorEnv("Reacher2", num_envs, seed=0),
             lambda: rng.uniform(-1, 1, (num_envs, 2)).astype(np.float32))
    print(f"\nenv-step throughput, {num_envs} envs x {steps} steps:")
    for name, sps in rows:
        print(f"  {name:42s} {sps:12,.0f} env-steps/s")
    return rows


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--bench", action="store_true", help="throughput comparison instead of training")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--bench-steps", type=int, default=2000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--max-epoch", type=int, default=4)
    p.add_argument("--step-per-epoch", type=int, default=10000)
    p.add_argument("--seed", type=int, default=0)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``: the two pools."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.cpp_pool import CppVectorEnv
    from tianshou_tpu_torch.envs.spaces import Discrete
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    algo = DQN(QNet(4, (128, 128, 128), 2), Discrete(2), lr=1e-3, gamma=0.9, n_step=3, target_update_freq=320,
               device=args.device)
    buffer = ReplayBuffer(2000, args.num_envs)
    train_venv = CppVectorEnv("CartPole-v1", args.num_envs, seed=args.seed)
    test_venv = CppVectorEnv("CartPole-v1", args.num_envs, seed=args.seed + 99)
    trainer = OffPolicyTrainer(
        algo,
        HostCollector(algo, train_venv, buffer, device=args.device),
        HostCollector(algo, test_venv, device=args.device),
        buffer,
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=10 * args.num_envs,
        update_per_step=0.1,
        batch_size=64,
        train_param_fn=lambda e, s: 0.1,
        stop_fn=lambda rew: rew >= 195,
        warmup_steps=1000,
        seed=args.seed,
        logger=logger,
        device=args.device,
    )
    return trainer, [train_venv, test_venv]


def main(argv=None, logger=None):
    """The training run's info, or ``None`` with ``--bench``."""
    args = parser().parse_args(argv)
    if args.bench:
        bench(args.num_envs, args.bench_steps)
        return None
    trainer, venvs = build(args, logger)
    info, dt = run(trainer, venvs)
    print(
        f"DQN/CartPole-v1 (cpp_pool): best={info.best_reward:.1f} "
        f"env_steps={info.env_step} wall={dt:.0f}s steps/s={info.env_step / dt:.0f}"
    )
    return info


if __name__ == "__main__":
    main()

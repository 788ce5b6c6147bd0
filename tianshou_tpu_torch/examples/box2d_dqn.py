"""Dueling DQN on Box2D's LunarLander through the host-env bridge (port of
``examples/box2d_dqn.py``; the reference's ``examples/box2d/lunarlander_dqn.py``).

Reference hyperparameters: dueling 128x128, lr 0.013, epsilon 0.73
decaying as ``0.73 * (1 - 5e-6) ** step`` down to the test epsilon, n-step
4, target update 500, 16 envs, 16 steps a collect, 0.0625 updates an env
step, batch 128, 10 epochs of 80,000 steps, solved at a test return of 200.
Needs gymnasium and Box2D.

    python -m tianshou_tpu_torch.examples.box2d_dqn [--device cpu]
"""

from __future__ import annotations

import argparse
import time

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="LunarLander-v3")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--test-envs", type=int, default=5)
    p.add_argument("--max-epoch", type=int, default=10)
    p.add_argument("--step-per-epoch", type=int, default=80000)
    p.add_argument("--step-per-collect", type=int, default=16)
    p.add_argument("--update-per-step", type=float, default=0.0625)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--buffer-size", type=int, default=100000)
    p.add_argument("--lr", type=float, default=0.013)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--n-step", type=int, default=4)
    p.add_argument("--target-update-freq", type=int, default=500)
    p.add_argument("--eps-train", type=float, default=0.73)
    p.add_argument("--eps-test", type=float, default=0.01)
    p.add_argument("--stop-reward", type=float, default=200.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logdir", default=None)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``; ``logger`` replaces the
    ``TensorboardLogger`` under ``--logdir``."""
    import gymnasium as gym

    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.host_collector import HostCollector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.host import HostVectorEnv, space_from_gym
    from tianshou_tpu_torch.networks.common import DuelingQNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    def make():
        return gym.make(args.task)

    probe = make()
    obs_shape, act_space = probe.observation_space.shape, space_from_gym(probe.action_space)
    probe.close()

    algo = DQN(
        DuelingQNet(obs_shape, (128, 128), act_space.n),
        act_space,
        lr=args.lr,
        gamma=args.gamma,
        n_step=args.n_step,
        target_update_freq=args.target_update_freq,
        device=args.device,
    )
    buffer = ReplayBuffer(args.buffer_size // args.num_envs, args.num_envs)
    train_venv = HostVectorEnv([make for _ in range(args.num_envs)])
    test_venv = HostVectorEnv([make for _ in range(args.test_envs)])
    if logger is None:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(args.logdir or f"log/lunar_dqn_{args.seed}_{int(time.time())}")
    trainer = OffPolicyTrainer(
        algo,
        HostCollector(algo, train_venv, buffer, device=args.device),
        HostCollector(algo, test_venv, device=args.device),
        buffer,
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.step_per_collect,
        update_per_step=args.update_per_step,
        batch_size=args.batch_size,
        episode_per_test=args.test_envs,
        # the reference's decay: eps_train * (1 - 5e-6) ** env_step, floored
        # at eps_test (lunarlander_dqn.py train_fn)
        train_param_fn=lambda e, s: max(args.eps_train * (1.0 - 5e-6) ** s, args.eps_test),
        test_param=args.eps_test,
        stop_fn=(lambda rew: rew >= args.stop_reward) if args.stop_reward else None,
        test_in_train=True,
        warmup_steps=args.batch_size * args.num_envs,
        seed=args.seed,
        logger=logger,
        device=args.device,
    )
    return trainer, [train_venv, test_venv]


def main(argv=None, logger=None):
    args = parser().parse_args(argv)
    trainer, venvs = build(args, logger)
    info, dt = run(trainer, venvs)
    print(
        f"DQN/{args.task}: best={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"env_steps={info.env_step} wall={dt:.0f}s steps/s={info.env_step/dt:.0f}"
    )
    return info


if __name__ == "__main__":
    main()

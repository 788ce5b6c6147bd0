"""DQN on the port's CartPole-v1, on the device (port of
``examples/dqn_cartpole.py``): the minimum end-to-end slice, the
reference's ``test/discrete/test_dqn.py`` run.  A test return of 195 stops
training.

    python -m tianshou_tpu_torch.examples.dqn_cartpole [--device cpu]
"""

from __future__ import annotations

import argparse

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=10)
    p.add_argument("--buffer-size", type=int, default=20000)
    p.add_argument("--max-epoch", type=int, default=10)
    p.add_argument("--step-per-epoch", type=int, default=10000)
    p.add_argument("--step-per-collect", type=int, default=100)
    p.add_argument("--update-per-step", type=float, default=0.1)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--n-step", type=int, default=3)
    p.add_argument("--target-update-freq", type=int, default=320)
    p.add_argument("--eps-train", type=float, default=0.1)
    p.add_argument("--eps-test", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``: the envs run on the device, none to
    close."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.classic import CartPole
    from tianshou_tpu_torch.networks.common import QNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    env = CartPole()
    algo = DQN(
        QNet(env.observation_space.shape, (128, 128, 128), 2),
        env.action_space,
        lr=args.lr,
        gamma=args.gamma,
        n_step=args.n_step,
        target_update_freq=args.target_update_freq,
        device=args.device,
    )
    buffer = ReplayBuffer(args.buffer_size // args.num_envs, args.num_envs)
    trainer = OffPolicyTrainer(
        algo,
        Collector(algo, VectorEnv(env, args.num_envs, device=args.device), buffer, device=args.device),
        Collector(algo, VectorEnv(env, args.num_envs, device=args.device), device=args.device),
        buffer,
        max_epoch=args.max_epoch,
        step_per_epoch=args.step_per_epoch,
        step_per_collect=args.step_per_collect,
        update_per_step=args.update_per_step,
        batch_size=args.batch_size,
        episode_per_test=10,
        train_param_fn=lambda epoch, step: args.eps_train,
        test_param=args.eps_test,
        stop_fn=lambda rew: rew >= 195,
        warmup_steps=1000,
        seed=args.seed,
        logger=logger,
        device=args.device,
    )
    return trainer, []


def main(argv=None, logger=None):
    args = parser().parse_args(argv)
    trainer, venvs = build(args, logger)
    info, dt = run(trainer, venvs)
    print(
        f"best_reward={info.best_reward:.1f}±{info.best_reward_std:.1f} "
        f"epochs={info.epoch} env_steps={info.env_step} "
        f"grad_steps={info.gradient_step} wall={dt:.1f}s "
        f"steps/s={info.env_step / dt:.0f} stop={info.stop_triggered}"
    )
    return info


if __name__ == "__main__":
    main()

"""ConvDQN or QRDQN on the port's MinAtar games, on the device (port of
``examples/dqn_minatar.py``; the reference's ``examples/atari/atari_dqn.py``
on pixel observations).  The games step batched on the device, so the
whole loop (env step, conv forward, replay, updates) stays there.

    python -m tianshou_tpu_torch.examples.dqn_minatar --game breakout [--algo qrdqn] [--device cpu]
"""

from __future__ import annotations

import argparse

from tianshou_tpu_torch.examples import run


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--game", default="breakout",
                   choices=["breakout", "space_invaders", "freeway", "asterix", "seaquest"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--buffer-size", type=int, default=100_000)
    p.add_argument("--max-epoch", type=int, default=10)
    p.add_argument("--step-per-epoch", type=int, default=100_000)
    p.add_argument("--step-per-collect", type=int, default=128)
    p.add_argument("--update-per-step", type=float, default=0.25)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--gamma", type=float, default=0.99)
    p.add_argument("--n-step", type=int, default=3)
    p.add_argument("--target-update-freq", type=int, default=1000)
    p.add_argument("--eps-train", type=float, default=0.1)
    p.add_argument("--eps-test", type=float, default=0.0)
    # MinAtar-paper exploration: linear 1.0 -> eps-train over the first
    # --eps-decay-steps env steps (0 = constant eps-train)
    p.add_argument("--eps-decay-steps", type=int, default=0)
    p.add_argument("--stop-reward", type=float, default=None)
    p.add_argument("--dueling", action="store_true")
    p.add_argument("--algo", default="dqn", choices=["dqn", "qrdqn"])
    p.add_argument("--num-quantiles", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logdir", default=None)
    return p


def build(args, logger=None):
    """``(trainer, venvs to close)``: the envs run on the device, none to
    close.  ``logger`` replaces the ``TensorboardLogger`` that ``--logdir``
    asks for."""
    from tianshou_tpu_torch.algos.dqn import DQN
    from tianshou_tpu_torch.algos.qrdqn import QRDQN
    from tianshou_tpu_torch.collect.collector import Collector
    from tianshou_tpu_torch.data.buffer import ReplayBuffer
    from tianshou_tpu_torch.envs.base import VectorEnv
    from tianshou_tpu_torch.envs.minatar import make_minatar
    from tianshou_tpu_torch.networks.conv import ConvDuelingQNet, ConvQNet, ConvQRDQNNet
    from tianshou_tpu_torch.trainer.offpolicy import OffPolicyTrainer

    env = make_minatar(args.game)
    obs_shape, n_act = env.observation_space.shape, env.action_space.n
    common = dict(lr=args.lr, gamma=args.gamma, n_step=args.n_step, target_update_freq=args.target_update_freq,
                  device=args.device)
    if args.algo == "qrdqn":
        algo = QRDQN(ConvQRDQNNet(obs_shape, n_act, args.num_quantiles, "minatar"), env.action_space,
                     num_quantiles=args.num_quantiles, **common)
    else:
        net_cls = ConvDuelingQNet if args.dueling else ConvQNet
        algo = DQN(net_cls(obs_shape, n_act, "minatar"), env.action_space, **common)
    buffer = ReplayBuffer(args.buffer_size // args.num_envs, args.num_envs)

    if args.eps_decay_steps > 0:

        def eps_fn(epoch, step):
            frac = min(1.0, step / args.eps_decay_steps)
            return 1.0 + frac * (args.eps_train - 1.0)

    else:

        def eps_fn(epoch, step):
            return args.eps_train

    if logger is None and args.logdir:
        from tianshou_tpu_torch.utils.logger import TensorboardLogger

        logger = TensorboardLogger(args.logdir)
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
        train_param_fn=eps_fn,
        test_param=args.eps_test,
        stop_fn=(lambda rew: rew >= args.stop_reward) if args.stop_reward else None,
        warmup_steps=5000,
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
        f"game={args.game} best_reward={info.best_reward:.1f}"
        f"±{info.best_reward_std:.1f} epochs={info.epoch} "
        f"env_steps={info.env_step} grad_steps={info.gradient_step} "
        f"wall={dt:.1f}s steps/s={info.env_step / dt:.0f}"
    )
    return info


if __name__ == "__main__":
    main()
